"""The port's per-node reductions and affine scan against the JAX package.

Mirrors ``tests/test_segment_ell.py`` (the ELL reductions against the
segment reductions, and both layouts' trajectories) and
``tests/test_pairwise.py::test_segmented_affine_scan_matches_loop``, and
holds each port function against its JAX twin on the same numpy-seeded
inputs: the CSR ``segment_reduce`` path is bit-exact to JAX's sorted
scatter (both add each row front to back), min/max/all are bit-exact
everywhere, the ELL sums agree to 1e-13, and the affine scan to 1e-12 at
float64 (it is in fact bit-exact: it repeats ``associative_scan``'s
pairing).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_updating_tpu.ops import segment as jseg
from flow_updating_tpu.ops.segscan import segmented_affine_scan as jscan
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.models.rounds import node_estimates, run_rounds
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.ops import segment as pseg
from flow_updating_tpu_torch.ops.segscan import segmented_affine_scan
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ba():
    return pgen.barabasi_albert(300, m=3, seed=7)


@pytest.fixture(scope="module")
def ba_arrays(ba):
    return ba.device_arrays(segment_ell=True, device="cpu")


@pytest.fixture(scope="module")
def isolated():
    """A graph with isolated nodes: empty rows read the identity."""
    from flow_updating_tpu_torch.topology.graph import build_topology

    return build_topology(8, [(0, 1), (1, 2), (2, 3), (5, 6)],
                          warn_asymmetric=False)


def test_ell_reductions_match_segment_ops(ba, ba_arrays):
    rng = np.random.default_rng(0)
    E = ba.num_edges
    x = torch.from_numpy(rng.normal(size=E))
    pred = torch.from_numpy(rng.random(E) < 0.5)
    mats, inv, deg = ba_arrays.ell_edge_mats, ba_arrays.ell_inv_perm, \
        ba_arrays.out_deg
    torch.testing.assert_close(pseg.ell_segment_sum(x, mats, inv),
                               pseg.segment_sum(x, deg), rtol=1e-13,
                               atol=1e-13)
    assert torch.equal(pseg.ell_segment_min(x, mats, inv, np.inf),
                       pseg.segment_min(x, deg))
    assert torch.equal(pseg.ell_segment_max(x, mats, inv, -np.inf),
                       pseg.segment_max(x, deg))
    assert torch.equal(pseg.ell_segment_all(pred, mats, inv, deg),
                       pseg.segment_all(pred, deg))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("features", [0, 3])
def test_segment_ops_equal_jax(isolated, ba, dtype, features):
    rng = np.random.default_rng(1)
    for topo in (ba, isolated):
        E, N = topo.num_edges, topo.num_nodes
        shape = (E,) + ((features,) if features else ())
        x = (rng.integers(-1000, 1000, shape).astype(dtype)
             if dtype == np.int32 else rng.normal(size=shape).astype(dtype))
        src = jnp.asarray(topo.src)
        deg = torch.from_numpy(topo.out_deg)
        for op in ("sum", "min", "max"):
            want = np.asarray(getattr(jseg, f"segment_{op}")(
                jnp.asarray(x), src, N))
            got = getattr(pseg, f"segment_{op}")(torch.from_numpy(x), deg)
            assert got.dtype == torch.from_numpy(x).dtype
            np.testing.assert_array_equal(got.numpy(), want, err_msg=op)
        pred = rng.random(E) < 0.7
        np.testing.assert_array_equal(
            pseg.segment_all(torch.from_numpy(pred), deg).numpy(),
            np.asarray(jseg.segment_all(jnp.asarray(pred), src, N)))


def test_ell_and_rows_ops_equal_jax(ba):
    jt = jgen.barabasi_albert(300, m=3, seed=7)
    ja = jt.device_arrays(segment_ell=True)
    pa = ba.device_arrays(segment_ell=True, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(ba.num_edges, 2))
    pred = rng.random(ba.num_edges) < 0.6
    tx = torch.from_numpy(x)
    mats, inv = pa.ell_edge_mats, pa.ell_inv_perm
    np.testing.assert_allclose(pseg.ell_segment_sum(tx, mats, inv).numpy(),
                               np.asarray(jseg.ell_segment_sum(x, ja)),
                               rtol=1e-13, atol=1e-13)
    for op, ident in (("min", np.inf), ("max", -np.inf)):
        np.testing.assert_array_equal(
            getattr(pseg, f"ell_segment_{op}")(tx, mats, inv,
                                               ident).numpy(),
            np.asarray(getattr(jseg, f"ell_segment_{op}")(x, ja, ident)))
    np.testing.assert_array_equal(
        pseg.ell_segment_all(torch.from_numpy(pred), mats, inv,
                             pa.out_deg).numpy(),
        np.asarray(jseg.ell_segment_all(pred, ja)))
    # the sweep's uniform-width rows: (N, W) out-edge slots, pad = E
    W = int(ba.out_deg.max())
    rows = np.full((ba.num_nodes, W), ba.num_edges, np.int32)
    for u in range(ba.num_nodes):
        lo, hi = ba.row_start[u], ba.row_start[u + 1]
        rows[u, : hi - lo] = np.arange(lo, hi)
    tr = torch.from_numpy(rows.astype(np.int64))
    np.testing.assert_array_equal(
        pseg.rows_segment_sum(tx, tr).numpy(),
        np.asarray(jseg.rows_segment_sum(x, jnp.asarray(rows))))
    np.testing.assert_array_equal(
        pseg.rows_segment_min(tx, tr, np.inf).numpy(),
        np.asarray(jseg.rows_segment_min(x, jnp.asarray(rows), np.inf)))
    np.testing.assert_array_equal(
        pseg.rows_segment_max(tx, tr, -np.inf).numpy(),
        np.asarray(jseg.rows_segment_max(x, jnp.asarray(rows), -np.inf)))
    np.testing.assert_array_equal(
        pseg.rows_segment_all(torch.from_numpy(pred), tr,
                              pa.out_deg).numpy(),
        np.asarray(jseg.rows_segment_all(pred, jnp.asarray(rows),
                                         jnp.asarray(ba.out_deg))))


@pytest.mark.parametrize("variant", ["collectall", "pairwise"])
def test_ell_trajectories_match(ba, ba_arrays, variant):
    cfg = RoundConfig.reference(variant=variant, dtype="float64")
    seg_arrays = ba.device_arrays(device="cpu")
    state0 = init_state(ba, cfg, device="cpu")
    out_seg = run_rounds(state0, seg_arrays, cfg, 120)
    out_ell = run_rounds(state0, ba_arrays, cfg, 120)
    torch.testing.assert_close(node_estimates(out_seg, seg_arrays),
                               node_estimates(out_ell, ba_arrays),
                               rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(out_seg.flow, out_ell.flow, rtol=1e-10,
                               atol=1e-10)


def test_engine_segment_impl_knob(ba):
    ests = {}
    for impl in ("segment", "ell"):
        cfg = RoundConfig.fast(variant="collectall", dtype="float64",
                               segment_impl=impl)
        e = Engine(config=cfg, device="cpu").set_topology(ba).build()
        e.run_rounds(60)
        ests[impl] = e.estimates()
    np.testing.assert_allclose(ests["segment"], ests["ell"], rtol=1e-10,
                               atol=1e-10)
    assert np.max(np.abs(ests["ell"] - ba.true_mean)) < 1e-6


@pytest.mark.parametrize("n", [1, 2, 257, 1024])
@pytest.mark.parametrize("features", [0, 2])
def test_segmented_affine_scan_matches_loop_and_jax(n, features):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.3, 1.5, n)
    b = rng.normal(size=(n,) + ((features,) if features else ()))
    seg_start = rng.uniform(size=n) < 0.2
    seg_start[0] = True
    A, B = segmented_affine_scan(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(seg_start))
    A_ref = np.empty(n)
    B_ref = np.empty_like(b)
    for i in range(n):
        if seg_start[i]:
            A_ref[i], B_ref[i] = a[i], b[i]
        else:
            A_ref[i] = a[i] * A_ref[i - 1]
            B_ref[i] = a[i] * B_ref[i - 1] + b[i]
    np.testing.assert_allclose(A.numpy(), A_ref, rtol=1e-12)
    np.testing.assert_allclose(B.numpy(), B_ref, rtol=1e-12, atol=1e-12)
    jA, jB = jscan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(seg_start))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=1e-12,
                               atol=1e-12)
