"""flow_updating_tpu_torch — the Flow-Updating framework on PyTorch and CUDA.

The port of ``flow_updating_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100, slice by slice.  Module names follow the JAX package so each
counterpart is easy to find; the JAX package stays the reference every
part is tested against.  This package imports ``torch`` and ``numpy`` and
nothing of JAX.

Ported so far: the topology layer (generators, XML loaders), the
node-collapsed fast synchronous round (``models/sync.py``) with its four
neighbor-sum paths, the topology compiler (RCM + banded plan), the
``Engine`` façade and the ``run`` CLI.  The TPU's two kernels on that path
are hand-written CUDA for Hopper (``csrc/``): the ELL neighbor sum
(``spmv='pallas'``) and the one-kernel banded round
(``spmv='banded_fused'``).  Everything runs on the CUDA card unless the
caller passes ``device='cpu'``.
"""

__version__ = "0.1.0"

from flow_updating_tpu_torch.engine import Engine
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.sync import NodeKernel
from flow_updating_tpu_torch.topology.graph import (
    Topology,
    build_topology,
    topology_from_arrays,
)

__all__ = [
    "Engine",
    "NodeKernel",
    "RoundConfig",
    "Topology",
    "build_topology",
    "topology_from_arrays",
]
