"""Payload-shape helpers shared by the node kernel and its neighbor sums.

Counterpart of the payload helpers of ``flow_updating_tpu/models/state.py``
(``_ex``, ``check_payload_values``); the edge kernel's state
(``FlowUpdatingState``, ``init_state``) is a later port item.
"""

from __future__ import annotations

import numpy as np
import torch


def _ex(m: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Append singleton axes so a per-node array (a mask or a per-node
    scalar) broadcasts over a payload's trailing feature axis."""
    extra = ref.dim() - m.dim()
    return m.reshape(m.shape + (1,) * extra) if extra > 0 else m


def check_payload_values(values: np.ndarray, num_nodes: int) -> None:
    """Payloads are ``(N,)`` scalar or ``(N, D)`` — one feature axis."""
    if values.shape[0] != num_nodes:
        raise ValueError(
            f"values must have leading dimension {num_nodes} "
            f"(got {values.shape})")
    if values.ndim > 2:
        raise ValueError(
            f"values must be (N,) or (N, D) — got shape {values.shape}; "
            "flatten extra feature axes to one")
