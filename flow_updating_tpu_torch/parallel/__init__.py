"""Multi-device execution of the port (counterpart of
``flow_updating_tpu/parallel``).

Ported: the mesh (:mod:`.mesh`, shards of the node axis in one process)
and the sharded one-kernel banded round (:mod:`.banded_sharded`,
``Engine(mesh=...)`` with ``spmv='banded_fused'``).  The halo edge kernel,
the sharded Beneš neighbor sum, GSPMD's node path, the feature axis and
the multi-host runs are later ROADMAP items (A12).
"""

from flow_updating_tpu_torch.parallel.mesh import NODE_AXIS, Mesh, make_mesh

__all__ = ["NODE_AXIS", "Mesh", "make_mesh"]
