"""Multi-device execution of the port (counterpart of
``flow_updating_tpu/parallel``).

Ported: the mesh (:mod:`.mesh`, shards of the node axis in one process),
the sharded one-kernel banded round (:mod:`.banded_sharded`,
``Engine(mesh=...)`` with ``spmv='banded_fused'``), the node round with a
Beneš network per shard (:mod:`.spmv_sharded`, ``spmv='benes_fused'``),
the pod-sharded fat-tree stencil (:mod:`.structured_sharded`,
``Engine(mesh=..., multichip='pod')``) and the halo edge kernel
(:mod:`.sharded` with the overlap schedule of :mod:`.overlap` and kernel
B6, ``Engine(mesh=..., multichip='halo')``).  GSPMD's paths, the feature
axis and the multi-host runs are later ROADMAP items (A12 part 4).
"""

from flow_updating_tpu_torch.parallel.mesh import NODE_AXIS, Mesh, make_mesh
from flow_updating_tpu_torch.parallel.spmv_sharded import ShardedNodeKernel
from flow_updating_tpu_torch.parallel.structured_sharded import (
    PodShardedFatTreeKernel,
)

__all__ = ["NODE_AXIS", "Mesh", "PodShardedFatTreeKernel",
           "ShardedNodeKernel", "make_mesh"]
