"""Payload-bytes and fused-round attribution (counterpart of a subset of
``flow_updating_tpu/obs/profile.py``).

:func:`payload_bytes_per_round` is the wire accounting of deep-payload
runs (the bytes term of ``plan/select.select_payload_schedule``);
:func:`fused_round_report` the one-kernel round's bytes per round, which
``Engine.plan_report`` embeds as ``fused_round``.  The cost analysis of
lowered programs, ``profile_program`` and the overlap traces are
ROADMAP A14.
"""

from __future__ import annotations


def payload_bytes_per_round(num_edges: int, features: int, *,
                            chunk: int | None = None,
                            feature_shards: int = 1,
                            dtype_bytes: int = 4) -> dict:
    """Edge-payload wire bytes of one underlying gossip round: ``E *
    width`` payload words, ``width = D`` monolithic or ``c`` chunked (a
    full model stream then costs ``D/c`` rounds and the same total
    bytes); feature sharding divides the per-device share by ``S_f``."""
    if features <= 0:
        raise ValueError("features must be >= 1 for payload accounting")
    width = int(chunk) if chunk else int(features)
    if chunk and (chunk <= 0 or features % chunk):
        raise ValueError(
            f"chunk={chunk} must be a positive divisor of D={features}")
    if feature_shards < 1:
        raise ValueError("feature_shards must be >= 1")
    per_round = num_edges * width * dtype_bytes
    return {
        "features": int(features),
        "chunk": int(chunk) if chunk else None,
        "width": width,
        "dtype_bytes": int(dtype_bytes),
        "bytes_per_round": per_round,
        "bytes_per_round_per_device": per_round // feature_shards,
        "rounds_per_model_stream": (int(features) // width),
        "bytes_per_model_stream": num_edges * features * dtype_bytes,
    }


def fused_round_report(kernel) -> dict | None:
    """Bytes-per-round attribution of a ``spmv='banded_fused'``
    :class:`~flow_updating_tpu_torch.models.sync.NodeKernel`
    (:func:`~flow_updating_tpu_torch.ops.fused_round.fused_round_bytes`);
    None for kernels without a fused spec."""
    spec = getattr(getattr(kernel, "arrays", None), "fused", None)
    if spec is None:
        return None
    import numpy as np

    from flow_updating_tpu_torch.ops.fused_round import fused_round_bytes

    feats = int(np.prod(kernel.feature_shape)) \
        if getattr(kernel, "feature_shape", ()) else 1
    return fused_round_bytes(spec, dtype_bytes=kernel.dtype.itemsize,
                             features=feats)
