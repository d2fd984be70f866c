"""Topology compiler: any graph -> a near-regular execution plan.

Counterpart of ``flow_updating_tpu/plan/``: reverse Cuthill-McKee
reordering (:mod:`.rcm`), dense masked-roll band lanes plus a gather
remainder (:mod:`.banded`), bound together by :func:`compile_topology`.
The banded plan runs either as plain tensor ops (``spmv='banded'``) or as
one CUDA kernel per round (``spmv='banded_fused'``,
:mod:`flow_updating_tpu_torch.ops.fused_round`).  Automatic plan selection
(``plan='auto'``) waits for its H100 cost model (ROADMAP).
"""

from flow_updating_tpu_torch.plan.banded import (
    BandedLeaves,
    BandedSpmvPlan,
    banded_neighbor_sum,
    banded_remainder_sum,
    build_banded,
)
from flow_updating_tpu_torch.plan.compile import (
    ExecutionPlan,
    compile_topology,
    reorder_topology_stable,
)
from flow_updating_tpu_torch.plan.rcm import (
    adjacency_bandwidth,
    offset_profile,
    rcm_order,
)

__all__ = [
    "BandedLeaves",
    "BandedSpmvPlan",
    "ExecutionPlan",
    "adjacency_bandwidth",
    "banded_neighbor_sum",
    "banded_remainder_sum",
    "build_banded",
    "compile_topology",
    "offset_profile",
    "rcm_order",
    "reorder_topology_stable",
]
