from flow_updating_tpu_torch.topology.graph import (
    Topology,
    build_topology,
    topology_from_arrays,
)
from flow_updating_tpu_torch.topology.platform import Platform, load_platform
from flow_updating_tpu_torch.topology.deployment import (
    Deployment,
    load_deployment,
)

__all__ = [
    "Topology",
    "build_topology",
    "topology_from_arrays",
    "Platform",
    "load_platform",
    "Deployment",
    "load_deployment",
]
