"""flow_updating_tpu_torch — the Flow-Updating framework on PyTorch and CUDA.

The port of ``flow_updating_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100, slice by slice.  Module names follow the JAX package so each
counterpart is easy to find; the JAX package stays the reference every
part is tested against.  This package imports ``torch`` and ``numpy`` and
nothing of JAX.

Ported so far: the topology layer (generators, XML loaders), the general
per-edge round (``models/rounds.py``, the default kernel) with its segment
and delivery layouts, the node-collapsed fast synchronous round
(``models/sync.py``) with its neighbor-sum paths (the structured stencil
of the regular generators and virtual fat trees among them), the mesh
paths (``parallel/``: the sharded banded and Beneš rounds, the pod-sharded
fat-tree stencil and the halo edge round), the topology compiler
(RCM + banded plan), the ``Engine`` façade and the ``run`` CLI, with
node and link faults and checkpoints in the JAX package's archive layout
(``utils/checkpoint.py``).  The TPU kernels on those paths are
hand-written CUDA for Hopper (``csrc/``): the ELL neighbor sum, the
one-kernel banded round, the fused Beneš passes and the segmented scan /
fill-forward.  Everything runs on the CUDA card
unless the caller passes ``device='cpu'``.
"""

__version__ = "0.1.0"

from flow_updating_tpu_torch.engine import Engine
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.rounds import (
    node_estimates,
    round_step,
    run_rounds,
)
from flow_updating_tpu_torch.models.state import (
    FlowUpdatingState,
    init_state,
    state_from_numpy,
)
from flow_updating_tpu_torch.models.sync import NodeKernel
from flow_updating_tpu_torch.topology.graph import (
    Topology,
    build_topology,
    topology_from_arrays,
)

__all__ = [
    "Engine",
    "FlowUpdatingState",
    "NodeKernel",
    "RoundConfig",
    "Topology",
    "build_topology",
    "init_state",
    "node_estimates",
    "round_step",
    "run_rounds",
    "state_from_numpy",
    "topology_from_arrays",
]
