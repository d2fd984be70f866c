"""Kernel K1's plain version vs the JAX package's neighbor sums.

On a CPU tensor ``neighbor_sum_ell`` (the ``spmv='pallas'`` wrapper) takes
the plain gather + row-sum version; it is held against
``neighbor_sum_pallas`` run in Pallas interpret mode (as the JAX suite
runs it) and against the JAX ``sync.neighbor_sum``, on the same padded
bucket layout.  Tolerances: rtol=atol=1e-6 in float32 (the JAX contract,
``tests/test_sync.py::test_pallas_spmv_matches_xla``; the row sums add in
another order) and 1e-12 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_updating_tpu.models import sync as jsync
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.ops.pallas_spmv import neighbor_sum_pallas
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import NodeKernel, RoundConfig
from flow_updating_tpu_torch.ops.spmv import (
    neighbor_sum,
    neighbor_sum_ell,
    neighbor_sum_min_bytes,
)
from flow_updating_tpu_torch.topology import generators as pgen

TOL = {"float32": 1e-6, "float64": 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _layouts(make, spmv="pallas"):
    """Port and JAX node kernels of the same graph and their bucket
    matrices (the padded ELL layout both packages build)."""
    jk = jsync.NodeKernel(make(jgen), JaxConfig.fast(kernel="node",
                                                     spmv=spmv))
    pk = NodeKernel(make(pgen), RoundConfig.fast(kernel="node", spmv=spmv),
                    device="cpu")
    return pk, jk


def test_bucket_layout_matches_jax():
    pk, jk = _layouts(lambda g: g.barabasi_albert(400, 3, seed=8))
    assert pk.padded_size == jk.padded_size
    assert pk.padded_size % 256 == 0
    assert len(pk.arrays.mats) == len(jk.arrays.mats)
    for a, b in zip(pk.arrays.mats, jk.arrays.mats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_k1_matches_pallas_interpret(dtype):
    pk, jk = _layouts(lambda g: g.barabasi_albert(400, 3, seed=8))
    x = np.random.default_rng(0).normal(size=pk.padded_size).astype(dtype)
    ref = np.asarray(neighbor_sum_pallas(jnp.asarray(x), jk.arrays.mats,
                                         interpret=True))
    before = neighbor_sum_ell.launches
    got = neighbor_sum_ell(torch.from_numpy(x), pk.arrays.mats).numpy()
    assert neighbor_sum_ell.launches == before   # CPU: the plain version
    assert got.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("graph", ["fat_tree", "erdos_renyi", "ring"])
def test_plain_k1_matches_jax_neighbor_sum(dtype, graph):
    make = {"fat_tree": lambda g: g.fat_tree(8, seed=1),
            "erdos_renyi": lambda g: g.erdos_renyi(300, 7.0, seed=2),
            "ring": lambda g: g.ring(50, 3, seed=0)}[graph]
    pk, jk = _layouts(make)
    x = np.random.default_rng(1).uniform(-1, 1, pk.padded_size).astype(dtype)
    ref = np.asarray(jsync.neighbor_sum(jnp.asarray(x), jk.arrays.mats))
    got = neighbor_sum_ell(torch.from_numpy(x), pk.arrays.mats).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_neighbor_sum_vector_payload_matches_jax():
    pk, jk = _layouts(lambda g: g.community(200, 4, seed=0), spmv="xla")
    x = np.random.default_rng(2).normal(size=(pk.padded_size, 3))
    ref = np.asarray(jsync.neighbor_sum(jnp.asarray(x, jnp.float64),
                                        jk.arrays.mats))
    got = neighbor_sum(torch.from_numpy(x), pk.arrays.mats).numpy()
    assert got.shape == (pk.padded_size, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    # each feature column is the scalar neighbor sum of that column, up to
    # the order torch's vectorized row sum adds in
    for d in range(3):
        col = neighbor_sum(torch.from_numpy(x[:, d].copy()),
                           pk.arrays.mats).numpy()
        np.testing.assert_allclose(got[:, d], col, rtol=1e-12, atol=1e-12)


def test_neighbor_sum_of_ones_is_degree():
    topo = pgen.barabasi_albert(150, 4, seed=5)
    pk = NodeKernel(topo, RoundConfig.fast(kernel="node", spmv="pallas"),
                    device="cpu")
    ones = torch.ones(pk.padded_size, dtype=torch.float64)
    deg = neighbor_sum_ell(ones, pk.arrays.mats)
    np.testing.assert_array_equal(deg.numpy(), pk.arrays.deg.numpy())


def test_min_bytes_counts_each_input_once():
    mats = (torch.zeros((256, 1), dtype=torch.int32),
            torch.zeros((256, 0), dtype=torch.int32),
            torch.zeros((512, 160), dtype=torch.int32))
    # x read once (1024 f32), 256 + 81920 indices, 1024 rows written
    assert neighbor_sum_min_bytes(mats, 1024, 4) == \
        1024 * 4 + 4 * (256 + 512 * 160) + 1024 * 4
