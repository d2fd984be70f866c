"""A-priori mixing estimation for Flow-Updating's round operator.

Counterpart of ``flow_updating_tpu/obs/spectral.py``.  The protocol's
averaging step applies the diffusion operator

    ``P = diag(1 / (deg + 1)) (I + A)``

(``models/sync.py``: ``avg = (...) * inv_depp1``) — a row-stochastic
matrix whose second eigenvalue ``lambda2`` sets how fast the estimate
spread contracts, so ``gap = 1 - |lambda2|`` is the topology's
convergence budget: a lane reaches relative tolerance ``eps`` in roughly
``ln(1/eps) / gap`` rounds.

Two provenances:

* **structural** — deflated power iteration for ``|lambda2|``, riding the
  port's own neighbor sums as the matvec (``plan/banded.
  banded_neighbor_sum`` when an :class:`ExecutionPlan` is given, else the
  edge rows summed by a CSR row reduction, ``ops/segment.segment_sum``);
* **measured** — a short run of the diffusion from a seeded random value
  vector, fitting the log-spread slope (:func:`.forecast.fit_log_decay`).

Both use seeded numpy start vectors and fixed-order reductions (no
atomics: the JAX package's ``.at[dst].add`` would be ``index_add_`` on
the card, whose float sums wander from run to run), so a cold probe on
one device gives the same gap bit for bit every time and a cached record
is reproducible.  Records persist in the autotune cache
(``plan/select.py``: same file, same atomic writer,
``FLOW_UPDATING_AUTOTUNE_CACHE`` honored) under version-gated
``mixing-v1`` keys that name the device, torch and CUDA versions and
dtype.

Closed forms: cycle ``C_n`` has ``lambda2 = (1 + 2 cos(2 pi / n)) / 3``;
the complete graph ``K_n`` has ``lambda2 = 0`` (gap exactly 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flow_updating_tpu_torch.obs.forecast import fit_log_decay

#: bump to invalidate every persisted mixing record (estimator change)
MIXING_VERSION = "mixing-v1"

#: persisted-record traffic since import (a hit recomputes nothing)
MIXING_CACHE_STATS = {"hits": 0, "misses": 0}

DEFAULT_POWER_ITERS = 128
DEFAULT_DECAY_ROUNDS = 64

#: successive |lambda2| estimates within this stop the power iteration
#: early (the Rayleigh sequence has converged)
_POWER_TOL = 1e-9


def predicted_rounds_to_eps(gap: float, eps: float) -> float:
    """``ln(1/eps) / gap`` — the a-priori rounds-to-tolerance estimate
    (inf on a non-positive gap; 0 when eps >= 1)."""
    if not (gap > 0.0):
        return float("inf")
    return max(0.0, math.log(1.0 / float(eps))) / float(gap)


def _diffusion_operator(topo, plan=None, *, device, dtype):
    """``(step, n, family, deg)``: one application of ``P`` in the
    lowering family the caller runs — banded rolls + remainder when a
    compiled plan is given (plan-order vectors), the edge rows otherwise.
    ``step`` maps a device vector to a device vector."""
    if plan is not None:
        from flow_updating_tpu_torch.plan.compile import _topo_key

        if plan.source_key and plan.source_key != _topo_key(topo):
            raise ValueError(
                "mixing probe: the plan was compiled from a different "
                "topology (source_key mismatch) — its banded masks "
                "would compute a different operator's gap")
        from flow_updating_tpu_torch.plan.banded import banded_neighbor_sum

        t = plan.topo               # RCM order — P's spectrum is
        n = t.num_nodes             # permutation-invariant
        deg = np.bincount(np.asarray(t.src), minlength=n)
        inv = torch.from_numpy(1.0 / (deg + 1.0)).to(device, dtype)
        leaves = plan.leaves.to(device)

        def step(x):
            return (x + banded_neighbor_sum(x, plan.spmv, leaves)) * inv

        return step, n, "banded", deg
    from flow_updating_tpu_torch.ops.segment import segment_sum

    topo._require_edges("the mixing probe (edge rows)")
    n = topo.num_nodes
    deg = np.bincount(np.asarray(topo.src), minlength=n)
    dst = torch.from_numpy(np.asarray(topo.dst, np.int64)).to(device)
    lengths = torch.from_numpy(deg.astype(np.int64)).to(device)
    inv = torch.from_numpy(1.0 / (deg + 1.0)).to(device, dtype)

    def step(x):
        # edges sorted by source: row i sums x over i's neighbors in a
        # fixed order (the graph is symmetric, so this is JAX's
        # sum over in-edges)
        return (x + segment_sum(x[dst], lengths)) * inv

    return step, n, "edge", deg


def _resolve(device, dtype):
    from flow_updating_tpu_torch.utils.device import resolve_device

    return resolve_device(device), getattr(torch, str(dtype))


def estimate_gap_structural(topo, *, plan=None,
                            iters: int = DEFAULT_POWER_ITERS,
                            seed: int = 0, device=None,
                            dtype: str = "float64") -> dict:
    """Deflated power iteration for ``|lambda2|`` of the diffusion
    operator — the structural provenance."""
    device, dt = _resolve(device, dtype)
    step, n, family, deg = _diffusion_operator(topo, plan, device=device,
                                               dtype=dt)
    if n < 2:
        return {"provenance": "structural", "family": family,
                "lambda2": 0.0, "gap": 1.0, "iters": 0,
                "seed": int(seed)}
    pi = torch.from_numpy((deg + 1.0) / float(np.sum(deg + 1.0))).to(
        device, dt)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(n)).to(device, dt)
    x = x - torch.sum(pi * x)               # deflate the stationary mode
    x = x / torch.linalg.norm(x)
    lam = prev = 0.0
    used = 0
    for used in range(1, int(iters) + 1):
        y = step(x)
        y = y - torch.sum(pi * y)           # re-deflate (roundoff drift)
        norm = float(torch.linalg.norm(y))
        if norm <= 0.0 or not math.isfinite(norm):
            lam = 0.0
            break
        lam = norm                          # ||P x|| / ||x||, ||x|| = 1
        x = y / norm
        if used > 8 and abs(lam - prev) < _POWER_TOL:
            break
        prev = lam
    lam = min(max(float(lam), 0.0), 1.0)
    return {
        "provenance": "structural",
        "family": family,
        "lambda2": lam,
        "gap": 1.0 - lam,
        "iters": int(used),
        "seed": int(seed),
    }


def estimate_gap_measured(topo, *, plan=None,
                          rounds: int = DEFAULT_DECAY_ROUNDS,
                          seed: int = 0, device=None,
                          dtype: str = "float64") -> dict:
    """Short run of the diffusion from a seeded random value vector,
    fitting the log-spread slope — the measured provenance (``rate =
    exp(slope)``, ``gap = 1 - rate``)."""
    device, dt = _resolve(device, dtype)
    step, n, family, _ = _diffusion_operator(topo, plan, device=device,
                                             dtype=dt)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random(n)).to(device, dt)
    # stop fitting at the dtype's roundoff floor: past it the spread
    # hovers on accumulation noise and a flat tail would wreck the slope
    floor = 100.0 * float(torch.finfo(dt).eps)
    ts, spreads = [], []
    for t in range(1, int(rounds) + 1):
        x = step(x)
        spread = float(torch.max(x) - torch.min(x))
        if not math.isfinite(spread) or spread <= floor:
            break
        ts.append(t)
        spreads.append(spread)
    fit = fit_log_decay(ts, spreads)
    if fit is None:
        # converged inside one step (complete-graph-like): the decay is
        # too fast to fit — report the open gap the data witnessed
        return {"provenance": "measured", "family": family,
                "rate": 0.0, "gap": 1.0, "rounds": len(ts),
                "seed": int(seed), "fit": None}
    rate = min(max(math.exp(fit["slope"]), 0.0), 1.0)
    return {
        "provenance": "measured",
        "family": family,
        "rate": rate,
        "gap": 1.0 - rate,
        "rounds": len(ts),
        "seed": int(seed),
        "fit": {k: float(v) for k, v in fit.items()},
    }


def _mixing_key(topo, family: str, *, power_iters: int,
                decay_rounds: int, seed: int, device=None,
                dtype: str = "float64") -> str:
    """Cache key: version x the device (type, name, torch and CUDA
    versions) x dtype x plan content hash x the probe configuration —
    any mismatch is a stale entry that re-probes."""
    from flow_updating_tpu_torch.plan.compile import _topo_key
    from flow_updating_tpu_torch.plan.select import _device_tag

    tk = _topo_key(topo)
    return (f"{MIXING_VERSION}|{_device_tag(device or 'cuda')}|dt{dtype}|"
            f"n{tk[0]}e{tk[1]}|{tk[2][:16]}|fam{family}|"
            f"pi{int(power_iters)}|dr{int(decay_rounds)}|s{int(seed)}")


def mixing_report(topo, *, plan=None, eps: float = 1e-6,
                  power_iters: int = DEFAULT_POWER_ITERS,
                  decay_rounds: int = DEFAULT_DECAY_ROUNDS,
                  seed: int = 0, cache_path: str | None = None,
                  refresh: bool = False, device=None,
                  dtype: str = "float64") -> dict:
    """The ``mixing`` block of plan manifests: both provenances, a
    headline gap, and the predicted rounds-to-``eps``, persisted in the
    autotune cache.  The probes run on ``device`` (default: the card).

    The headline ``gap`` prefers the measured provenance when its fit
    produced an in-range gap, falling back to structural.
    ``refresh=True`` forces a re-probe; a version or configuration
    mismatch re-probes implicitly."""
    from flow_updating_tpu_torch.plan.select import (
        _load_autotune_cache,
        _store_autotune_entry,
        autotune_cache_path,
    )
    from flow_updating_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    family = "banded" if plan is not None else "edge"
    path = cache_path or autotune_cache_path()
    key = _mixing_key(topo, family, power_iters=power_iters,
                      decay_rounds=decay_rounds, seed=seed, device=device,
                      dtype=dtype)
    entry = _load_autotune_cache(path).get(key)
    hit = (isinstance(entry, dict)
           and entry.get("version") == MIXING_VERSION
           and not refresh)
    if hit:
        MIXING_CACHE_STATS["hits"] += 1
    else:
        MIXING_CACHE_STATS["misses"] += 1
        entry = {
            "version": MIXING_VERSION,
            "structural": estimate_gap_structural(
                topo, plan=plan, iters=power_iters, seed=seed,
                device=device, dtype=dtype),
            "measured": estimate_gap_measured(
                topo, plan=plan, rounds=decay_rounds, seed=seed,
                device=device, dtype=dtype),
        }
        _store_autotune_entry(path, key, entry)
    st, me = entry["structural"], entry["measured"]
    if me.get("fit") is not None and 0.0 < float(me["gap"]) <= 1.0:
        gap, provenance = float(me["gap"]), "measured"
    else:
        gap, provenance = float(st["gap"]), "structural"
    return {
        "gap": gap,
        "provenance": provenance,
        "eps": float(eps),
        "predicted_rounds": predicted_rounds_to_eps(gap, eps),
        "family": family,
        "structural": dict(st),
        "measured": dict(me),
        "cache": {"path": path, "key": key, "hit": bool(hit)},
    }
