"""Multi-device execution of the port (counterpart of
``flow_updating_tpu/parallel``).

Ported: the mesh (:mod:`.mesh`, shards of the node axis in one process),
the sharded one-kernel banded round (:mod:`.banded_sharded`,
``Engine(mesh=...)`` with ``spmv='banded_fused'``) and the halo edge
kernel (:mod:`.sharded` with the overlap schedule of :mod:`.overlap` and
kernel B6, ``Engine(mesh=..., multichip='halo')``).  The sharded Beneš
neighbor sum, GSPMD's paths, the pod stencil, the feature axis and the
multi-host runs are later ROADMAP items (A12).
"""

from flow_updating_tpu_torch.parallel.mesh import NODE_AXIS, Mesh, make_mesh

__all__ = ["NODE_AXIS", "Mesh", "make_mesh"]
