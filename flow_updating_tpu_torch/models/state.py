"""The edge kernel's state, and the payload helpers shared by both kernels.

Counterpart of ``flow_updating_tpu/models/state.py``.  Everything a
reference peer keeps per actor (value, flows, estimates, received ids,
ticks since its last average, its last average) and everything SimGrid
keeps for it (the mailbox queue and the messages in flight) lives in one
:class:`FlowUpdatingState` of dense tensors.  Per-neighbor dicts become
per-directed-edge arrays; the mailbox is a depth-``Q`` FIFO per edge, the
in-flight set a ``(D, E)`` ring buffer keyed by the receiver's edge.

Payload arrays (``value``, ``flow``, ``est``, ``last_avg`` and the
pending/ring payload planes) may carry a trailing feature axis: ``values``
of shape ``(N, D)`` runs D scalar protocol instances that share one set
of messages.  Control arrays (masks, ticks, stamps) never grow one.

The PRNG key (message loss) is a ``(2,)`` int64 tensor holding the two
uint32 words of a ``jax.random`` key (:mod:`..utils.prng`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.utils import prng
from flow_updating_tpu_torch.utils.device import resolve_device


def _ex(m: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Append singleton axes so a per-node/per-edge control array (a mask
    or a scalar per element) broadcasts over a payload's trailing feature
    axis."""
    extra = ref.dim() - m.dim()
    return m.reshape(m.shape + (1,) * extra) if extra > 0 else m


def _feat(x: torch.Tensor) -> int:
    """Number of feature lanes of a payload array (1 for scalar)."""
    return int(x.numel() // x.shape[0]) if x.dim() > 1 else 1


def feature_shape(values) -> tuple:
    """Trailing feature axes of a payload array: ``()`` or ``(D,)``."""
    return tuple(values.shape[1:])


def check_payload_values(values, num_nodes: int) -> None:
    """Payloads are ``(N,)`` scalar or ``(N, D)`` — one feature axis."""
    if values.shape[0] != num_nodes:
        raise ValueError(
            f"values must have leading dimension {num_nodes} "
            f"(got {values.shape})")
    if values.ndim > 2:
        raise ValueError(
            f"values must be (N,) or (N, D) — got shape {values.shape}; "
            "flatten extra feature axes to one")


@dataclasses.dataclass(frozen=True)
class FlowUpdatingState:
    t: torch.Tensor             # () int32 — round counter
    value: torch.Tensor         # (N,) — local input values
    flow: torch.Tensor          # (E,) — f(src->dst) as known by src
    est: torch.Tensor           # (E,) — src's last known estimate of dst
    recv: torch.Tensor          # (E,) bool — heard from dst since last avg
    ticks: torch.Tensor         # (N,) int32 — ticks since last avg
    stamp: torch.Tensor         # (E,) int32 — round of last avg on edge
    last_avg: torch.Tensor      # (N,) — last computed average per node
    fired: torch.Tensor         # (N,) int32 — averaging events per node
    alive: torch.Tensor         # (N,) bool — liveness mask
    edge_ok: torch.Tensor       # (E,) bool — link-failure mask
    pending_flow: torch.Tensor  # (Q, E) — undrained message FIFO
    pending_est: torch.Tensor   # (Q, E)    (slot 0 = oldest)
    pending_valid: torch.Tensor  # (Q, E) bool
    pending_stamp: torch.Tensor  # (Q, E) int32 — arrival round
    buf_flow: torch.Tensor      # (D, E) — in-flight ring buffer
    buf_est: torch.Tensor       # (D, E)
    buf_valid: torch.Tensor     # (D, E) bool
    key: torch.Tensor           # (2,) int64 PRNG key words

    def replace(self, **kw) -> FlowUpdatingState:
        return dataclasses.replace(self, **kw)

    def to(self, device) -> FlowUpdatingState:
        return FlowUpdatingState(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    def numpy(self) -> dict:
        """Every field as a numpy array (the key as its uint32 words)."""
        out = {f.name: getattr(self, f.name).cpu().numpy()
               for f in dataclasses.fields(self)}
        out["key"] = out["key"].astype(np.uint32)
        return out


def init_state(topo, cfg, seed: int = 0, values=None,
               device=None) -> FlowUpdatingState:
    """Fresh state: zero flows/estimates, empty mailboxes and ring buffer.
    ``values`` is ``(N,)`` (default ``topo.values``) or ``(N, D)``.  The
    state lives on the card unless ``device='cpu'`` is given."""
    device = resolve_device(device)
    N, E, D = topo.num_nodes, topo.num_edges, cfg.delay_depth
    if D < topo.max_delay:
        raise ValueError(
            f"delay_depth={D} too small for topology max delay "
            f"{topo.max_delay} (need delay_depth >= max_delay)")
    dt = cfg.torch_dtype
    if values is None:
        values = topo.values
    values = np.asarray(values)
    check_payload_values(values, N)
    F = feature_shape(values)
    Q = cfg.pending_depth
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return FlowUpdatingState(
        t=z((), torch.int32),
        value=torch.as_tensor(values, dtype=dt).to(device),
        flow=z((E,) + F, dt),
        est=z((E,) + F, dt),
        recv=z((E,), torch.bool),
        ticks=z((N,), torch.int32),
        stamp=z((E,), torch.int32),
        last_avg=z((N,) + F, dt),
        fired=z((N,), torch.int32),
        alive=torch.ones((N,), dtype=torch.bool, device=device),
        edge_ok=torch.ones((E,), dtype=torch.bool, device=device),
        pending_flow=z((Q, E) + F, dt),
        pending_est=z((Q, E) + F, dt),
        pending_valid=z((Q, E), torch.bool),
        pending_stamp=z((Q, E), torch.int32),
        buf_flow=z((D, E) + F, dt),
        buf_est=z((D, E) + F, dt),
        buf_valid=z((D, E), torch.bool),
        key=prng.prng_key(seed, device=device),
    )


_INT_FIELDS = ("t", "ticks", "stamp", "fired", "pending_stamp")
_BOOL_FIELDS = ("recv", "alive", "edge_ok", "pending_valid", "buf_valid")


def state_from_numpy(fields, dtype=None, device=None) -> FlowUpdatingState:
    """A state from another state's fields as numpy arrays, by name — a
    JAX ``FlowUpdatingState`` read field by field (``np.asarray`` of
    each leaf) continues here.  ``fields`` is a mapping or an object
    with those attributes; payloads keep their dtype unless ``dtype``
    is given; the key's uint32 words become the int64 key.  The state
    lives on the card unless ``device='cpu'`` is given."""
    device = resolve_device(device)
    get = (fields.__getitem__ if isinstance(fields, dict)
           else lambda n: getattr(fields, n))
    out = {}
    for f in dataclasses.fields(FlowUpdatingState):
        a = np.asarray(get(f.name))
        if f.name == "key":
            t = torch.from_numpy(a.astype(np.uint32).astype(np.int64))
        elif f.name in _INT_FIELDS:
            t = torch.from_numpy(a.astype(np.int32))
        elif f.name in _BOOL_FIELDS:
            t = torch.from_numpy(a.astype(bool))
        else:
            t = torch.from_numpy(np.array(a))
            if dtype is not None:
                t = t.to(dtype)
        out[f.name] = t.to(device)
    return FlowUpdatingState(**out)
