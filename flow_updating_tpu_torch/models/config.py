"""Static round configuration.

Counterpart of ``flow_updating_tpu/models/config.py``: the same frozen
:class:`RoundConfig` — same fields, same defaults, same ``__post_init__``
validation and the same ``spmv`` value strings, so configurations and
command lines carry over unchanged.  ``torch_dtype`` replaces
``jnp_dtype``.  In this package ``spmv='pallas'`` names the hand-written
CUDA ELL neighbor-sum kernel (``ops/spmv.py``), ``'banded_fused'`` the
hand-written one-kernel round (``ops/fused_round.py``) and
``'benes_fused'`` the hand-written fused network passes
(``ops/fused_passes.py``).  The traced-knob
twin ``RoundParams`` belongs to the sweep engine and is not ported.

Mapping to the reference's knobs:

* ``variant``     — ``flowupdating-collectall.py`` vs
                    ``flowupdating-pairwise.py``.
* ``fire_policy`` — 'reference' reproduces the reference's firing rules;
                    'every_round' is the fast synchronous mode.
* ``drain``       — messages a node may process per round (0 = all).
* ``timeout``     — collect-all ticks before a forced average / pairwise
                    rounds of silence before re-initiation.
* ``delay_depth`` — in-flight ring-buffer depth (1 = unit delay).
* ``drop_rate``   — per-message loss probability.
"""

from __future__ import annotations

import dataclasses

COLLECTALL = "collectall"
PAIRWISE = "pairwise"


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    variant: str = COLLECTALL          # 'collectall' | 'pairwise'
    fire_policy: str = "every_round"   # 'every_round' | 'reference'
    drain: int = 0                     # max msgs processed /node/round; 0 = all
    timeout: int = 50                  # ticks (collectall) / rounds (pairwise)
    delay_depth: int = 1               # ring buffer depth D (static)
    pending_depth: int = 1             # per-edge mailbox FIFO depth Q.  The
    #                                    reference's SimGrid mailbox queues
    #                                    every unmatched put (collectall.py:
    #                                    74,123-125); depth 1 keeps only the
    #                                    newest undrained message per edge
    #                                    (idempotent for collect-all; for
    #                                    faithful pairwise it merges events
    #                                    and measurably slows convergence —
    #                                    see tests/test_dynamics_parity.py).
    #                                    Q > 1 queues up to Q per edge,
    #                                    drained oldest-first; overflow
    #                                    overwrites the newest slot.
    drop_rate: float = 0.0             # message loss probability
    contention: bool = False           # shared-link bandwidth contention:
    #                                    per round, concurrent sends crossing
    #                                    a SHARED link split its capacity
    #                                    (bottleneck fair share — the
    #                                    quasi-static approximation of
    #                                    SimGrid's max-min LMM solver,
    #                                    SURVEY.md N3); FATPIPE links never
    #                                    share.  Needs a platform-loaded
    #                                    topology with a link model and
    #                                    latency_scale > 0; delays are
    #                                    recomputed each round and clamped
    #                                    to delay_depth.
    contention_backlog: bool = False   # count STILL-IN-FLIGHT messages
    #                                    (the ring buffer's valid slots)
    #                                    as standing load on their route
    #                                    links when splitting capacity —
    #                                    the cross-tick queueing the
    #                                    dynamic LMM oracle models and a
    #                                    per-round-only solve misses (the
    #                                    measured 1.7-2.3x pairwise
    #                                    residual, tests/test_lmm.py).
    contention_iters: int = 0          # 0: each send pays its LOCAL
    #                                    bottleneck share (the historical
    #                                    quasi-static model).  k > 0: k
    #                                    progressive-filling iterations of
    #                                    the max-min water-fill per round —
    #                                    flows bottlenecked elsewhere
    #                                    release capacity to the rest,
    #                                    converging (in the number of
    #                                    distinct bottleneck levels) to the
    #                                    true max-min allocation of
    #                                    SimGrid's LMM for that round's
    #                                    send set.  Validated against the
    #                                    native dynamic-LMM oracle
    #                                    (native.des_run_contend(lmm=True),
    #                                    tests/test_lmm.py).
    dtype: str = "float32"             # ledger dtype
    kernel: str = "edge"               # 'edge' (general) | 'node' (collapsed
    #                                    SpMV recurrence; fast sync
    #                                    collect-all only, models/sync.py)
    delivery: str = "gather"           # single-device message delivery
    #                                    ('benes_fused' = benes network via
    #                                    fused Pallas passes):
    #                                    'gather' (receiver pulls through rev
    #                                    — elementwise over (D, E), no
    #                                    scatter) | 'scatter' (sender pushes;
    #                                    2-D dynamic-index scatter, slow on
    #                                    TPU) | 'benes' (the rev pull runs
    #                                    through the planned permutation
    #                                    network, ops/permute.py — no
    #                                    dynamic gather at all; single-
    #                                    device).  Identical semantics.
    spmv: str = "xla"                  # node-kernel neighbor sum: 'xla'
    #                                    (plain gather + rowsum) | 'pallas'
    #                                    (the CUDA ELL kernel, ops/spmv.py)
    #                                    | 'banded' (RCM masked-roll bands
    #                                    + gather remainder, plan/) |
    #                                    'banded_fused' (the whole round in
    #                                    one CUDA kernel over the banded
    #                                    plan, ops/fused_round.py) | 'benes'
    #                                    (permutation network, per-stage
    #                                    torch ops, ops/spmv_benes.py) |
    #                                    'benes_fused' (the same network as
    #                                    fused passes, the CUDA kernel of
    #                                    ops/fused_passes.py) | 'structured'
    #                                    (a regular generator's closed-form
    #                                    stencil, ops/structured.py)
    robust: str = "off"                # robust-aggregation variant of the
    #                                    fire/average step, BOTH protocol
    #                                    families (Byzantine tolerance,
    #                                    scenarios/).  Collect-all trims/
    #                                    clips the neighborhood average;
    #                                    pairwise applies the same ledger
    #                                    clamp to the 2-party exchange
    #                                    ('clip') or refuses to match /
    #                                    fire along its single highest-
    #                                    and lowest-estimate edges while
    #                                    the neighborhood spread exceeds
    #                                    robust_tol ('trim'):
    #                                    'off' (the historical average —
    #                                    statically off, the compiled
    #                                    program is bit-identical to
    #                                    before the knob existed) |
    #                                    'trim' (trimmed mean: each node
    #                                    with degree >= 3 whose
    #                                    neighborhood spread exceeds
    #                                    robust_tol drops its single
    #                                    highest and single lowest
    #                                    neighbor estimate — one edge
    #                                    each, rank-tie-broken — before
    #                                    averaging, and freezes those
    #                                    edges out of the exchange: one
    #                                    extreme liar per neighborhood is
    #                                    excluded outright) | 'clip'
    #                                    (clipped flows: the per-edge
    #                                    flow LEDGER is clamped to
    #                                    +-robust_clip at every write —
    #                                    fire deltas and receive-side
    #                                    antisymmetry writes alike — so
    #                                    no neighbor, honest or
    #                                    Byzantine, can claim more than
    #                                    robust_clip of standing mass
    #                                    displacement through any edge;
    #                                    pick robust_clip above the
    #                                    honest equilibrium |flow| or
    #                                    convergence itself is clipped)
    robust_clip: float = 0.0           # ledger clamp magnitude for
    #                                    robust='clip'
    robust_tol: float = 0.0            # trim arming threshold: a node
    #                                    only trims while its neighbor-
    #                                    estimate spread (max - min)
    #                                    exceeds this, so near-consensus
    #                                    neighborhoods fall back to the
    #                                    plain average instead of
    #                                    freezing their extremes forever
    #                                    (0.0 = any nonzero spread arms)
    segment_impl: str = "auto"         # edge-kernel per-node reductions:
    #                                    'segment' (jax.ops segment_* —
    #                                    scatter-based lowering) | 'ell'
    #                                    (degree-bucketed out-edge ELL
    #                                    gather + row-reduce, scatter-free;
    #                                    ops/segment.py) | 'benes'
    #                                    (permutation-network segmented
    #                                    scans + broadcasts, no gather OR
    #                                    scatter; ops/seg_benes.py — the
    #                                    TPU path) | 'auto' (= segment)

    def __post_init__(self):
        if self.variant not in (COLLECTALL, PAIRWISE):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.fire_policy not in ("every_round", "reference"):
            raise ValueError(f"unknown fire_policy {self.fire_policy!r}")
        if self.delay_depth < 1:
            raise ValueError("delay_depth must be >= 1")
        if self.drain < 0:
            raise ValueError("drain must be >= 0 (0 = unbounded)")
        if self.pending_depth < 1:
            raise ValueError("pending_depth must be >= 1")
        if self.pending_depth > 1 and self.drain == 0:
            # unbounded drain processes only the head slot per round, which
            # would silently turn "drain everything" into one-message-per-
            # round-per-edge with overflow loss — reject the combination
            raise ValueError(
                "pending_depth > 1 requires a bounded drain (drain >= 1): "
                "unbounded drain empties the mailbox every round, so a "
                "deeper queue only delays and drops messages"
            )
        if self.kernel not in ("edge", "node"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.delivery not in ("gather", "scatter", "benes",
                                 "benes_fused"):
            raise ValueError(f"unknown delivery {self.delivery!r}")
        if self.spmv not in ("xla", "pallas", "benes", "benes_fused",
                             "structured", "banded", "banded_fused"):
            raise ValueError(f"unknown spmv {self.spmv!r}")
        if self.segment_impl not in ("auto", "segment", "ell", "benes",
                                     "benes_fused"):
            raise ValueError(f"unknown segment_impl {self.segment_impl!r}")
        if (self.segment_impl in ("ell", "benes", "benes_fused")
                and self.kernel == "node"):
            raise ValueError(
                "segment_impl selects the edge kernel's reduction layout; "
                "the node kernel has its own "
                "(spmv='xla'|'pallas'|'benes'|'benes_fused')"
            )
        if self.delivery != "gather" and self.kernel == "node":
            raise ValueError(
                "delivery selects the edge kernel's message-delivery "
                "formulation; the node kernel has no per-edge messages — "
                "its knob is spmv"
            )
        if self.contention and self.kernel != "edge":
            raise ValueError(
                "contention recomputes per-edge delays each round; only the "
                "edge kernel carries the in-flight ring buffer (kernel='edge')"
            )
        if self.contention_iters < 0:
            raise ValueError("contention_iters must be >= 0")
        if self.contention_iters > 0 and not self.contention:
            raise ValueError(
                "contention_iters refines the shared-link bandwidth split; "
                "it needs contention=True"
            )
        if self.contention_backlog and not self.contention:
            raise ValueError(
                "contention_backlog adds in-flight load to the shared-link "
                "bandwidth split; it needs contention=True"
            )
        if self.robust not in ("off", "trim", "clip"):
            raise ValueError(f"unknown robust mode {self.robust!r} "
                             "(use 'off', 'trim' or 'clip')")
        if self.robust != "off" and self.kernel != "edge":
            raise ValueError(
                "robust aggregation is implemented in the edge kernel's "
                "fire phase; the node-collapsed SpMV recurrence has no "
                "per-edge ledgers to clip (kernel='edge')")
        if self.robust == "clip" and not self.robust_clip > 0.0:
            raise ValueError(
                "robust='clip' needs robust_clip > 0 (the flow-ledger "
                "clamp magnitude)")
        if self.robust != "clip" and self.robust_clip != 0.0:
            raise ValueError(
                "robust_clip is the ledger clamp magnitude of "
                "robust='clip'; set robust='clip' to use it")
        if self.robust_tol < 0.0:
            raise ValueError("robust_tol must be >= 0")
        if self.robust != "trim" and self.robust_tol != 0.0:
            raise ValueError(
                "robust_tol is the trim arming threshold of "
                "robust='trim'; set robust='trim' to use it")
        if self.kernel == "node" and not self.is_fast_sync_collectall:
            raise ValueError(
                "kernel='node' covers exactly the fast synchronous "
                "collect-all mode (every_round, drain=0, delay_depth=1, no "
                "message drop); use kernel='edge' otherwise"
            )

    @property
    def is_fast_sync_collectall(self) -> bool:
        """The node-collapsed kernel's domain of algebraic validity
        (see models/sync.py)."""
        return (self.variant == COLLECTALL
                and self.fire_policy == "every_round"
                and self.delay_depth == 1
                and self.drain == 0
                and self.drop_rate == 0.0
                and self.robust == "off")

    @property
    def torch_dtype(self):
        """The ledger dtype as a ``torch.dtype``."""
        import torch

        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported ledger dtype {self.dtype!r} "
                             "(use 'float32' or 'float64')")
        return getattr(torch, self.dtype)

    @property
    def use_segment_ell(self) -> bool:
        """Materialize the ELL out-edge matrices for scatter-free
        per-node reductions in the edge kernel."""
        return self.segment_impl == "ell"

    @property
    def use_segment_benes(self) -> bool:
        """Plan the permutation-network segmented reductions/broadcasts."""
        return self.segment_impl in ("benes", "benes_fused")

    @property
    def segment_benes_mode(self):
        """Value for ``Topology.device_arrays(segment_benes=...)``:
        ``False`` | ``True`` | ``"fused"``."""
        if self.segment_impl == "benes_fused":
            return "fused"
        return self.segment_impl == "benes"

    @property
    def delivery_benes_mode(self):
        """Value for ``Topology.device_arrays(delivery_benes=...)``:
        ``False`` | ``True`` | ``"fused"``."""
        if self.delivery == "benes_fused":
            return "fused"
        return self.delivery == "benes"

    @property
    def needs_coloring(self) -> bool:
        """Fast synchronous pairwise fires one edge-color class per round."""
        return self.variant == PAIRWISE and self.fire_policy == "every_round"

    @classmethod
    def reference(cls, variant: str = COLLECTALL, **kw) -> RoundConfig:
        """The faithful mode: reproduces the reference's asynchronous
        dynamics (1 msg/round drain, 50-round timeouts, depth-2 mailbox
        FIFO — tests/test_dynamics_parity.py shows rounds-to-RMSE curves
        match the DES oracle to within ~6% at depth 2, while depth 1's
        newest-wins merge converges measurably *faster* than the
        reference)."""
        kw.setdefault("fire_policy", "reference")
        kw.setdefault("drain", 1)
        kw.setdefault("timeout", 50)
        kw.setdefault("pending_depth", 2)
        return cls(variant=variant, **kw)

    @classmethod
    def fidelity(cls, variant: str = COLLECTALL, **kw) -> RoundConfig:
        """The measured-best network-fidelity preset: faithful dynamics +
        shared-link contention with the per-round max-min water-fill, and
        (pairwise only) in-flight backlog accounting.  These are the
        configurations pinned against the dynamic LMM oracle in
        tests/test_lmm.py — collect-all within ~7% of the true dynamic
        semantics, pairwise inside the oracle's event-ordering band.
        Needs a platform-loaded topology with a link model."""
        kw.setdefault("contention", True)
        if kw["contention"]:
            kw.setdefault("contention_iters", 4)
            kw.setdefault("contention_backlog", variant == PAIRWISE)
        return cls.reference(variant=variant, **kw)

    @classmethod
    def fast(cls, variant: str = COLLECTALL, **kw) -> RoundConfig:
        """The throughput mode: synchronous averaging every round."""
        kw.setdefault("fire_policy", "every_round")
        kw.setdefault("drain", 0)
        return cls(variant=variant, **kw)
