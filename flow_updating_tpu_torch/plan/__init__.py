"""Topology compiler: any graph -> a near-regular execution plan.

Counterpart of ``flow_updating_tpu/plan/``: reverse Cuthill-McKee
reordering (:mod:`.rcm`), dense masked-roll band lanes plus a gather
remainder (:mod:`.banded`), bound together by :func:`compile_topology`.
The banded plan runs either as plain tensor ops (``spmv='banded'``) or as
one CUDA kernel per round (``spmv='banded_fused'``,
:mod:`flow_updating_tpu_torch.ops.fused_round`).  :func:`select_plan` is
the auto-mode policy (``Engine(plan='auto')``): an analytic cost model
with the H100's measured gather penalty, and measured probes of the
banded family on the engine's device through a persistent autotune cache
(:func:`autotune_fused`).
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
from flow_updating_tpu_torch.plan.select import (
    PlanDecision,
    autotune_fused,
    select_plan,
)

__all__ = [
    "BandedLeaves",
    "BandedSpmvPlan",
    "ExecutionPlan",
    "PlanDecision",
    "adjacency_bandwidth",
    "autotune_fused",
    "banded_neighbor_sum",
    "banded_remainder_sum",
    "build_banded",
    "compile_topology",
    "offset_profile",
    "rcm_order",
    "reorder_topology_stable",
    "select_plan",
]
