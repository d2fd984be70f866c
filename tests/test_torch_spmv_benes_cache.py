"""The on-disk plan cache of the port's Beneš neighbor sum (JAX
``tests/test_spmv_benes_cache.py``, through the port).

``plan_neighbor_sum`` persists each routed base plan under
``FU_PLAN_CACHE`` (``0`` turns it off, a path moves it, the default is
the port's own ``$XDG_CACHE_HOME/flow_updating_tpu_torch/plans``) in the
JAX package's layout — bit-packed masks, zlib, a JSON ``meta`` record —
and reloads it in a later process: the same stages and a bit-identical
run.  A corrupt file warns and the plan is routed again; nothing is ever
written while the cache is off.  The environment is set with
``monkeypatch`` throughout, so no test writes into the user's cache.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import flow_updating_tpu.ops.spmv_benes as jsb
import flow_updating_tpu_torch.ops.spmv_benes as sb
from flow_updating_tpu.models import sync as jsync
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import NodeKernel, RoundConfig
from flow_updating_tpu_torch.topology.generators import fat_tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch, tmp_path):
    """Every test starts with empty in-process caches, and with the disk
    cache pointed away from the user's directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.delenv("FU_PLAN_CACHE", raising=False)
    sb._plan_cache.clear()
    jsb._plan_cache.clear()
    yield
    sb._plan_cache.clear()
    jsb._plan_cache.clear()


def _kernel(topo, spmv="benes"):
    cfg = RoundConfig.fast(variant="collectall", kernel="node", spmv=spmv,
                           dtype="float64")
    return NodeKernel(topo, cfg, device="cpu")


def _assert_same_plan(p1, p2):
    assert (p1.m1, p1.P, p1.flat_begin, p1.bucket_shapes) == (
        p2.m1, p2.P, p2.flat_begin, p2.bucket_shapes)
    assert p1.stages.n == p2.stages.n
    assert p1.stages.dists == p2.stages.dists
    assert p1.stages.kinds == p2.stages.kinds
    for a, b in zip(p1.stages.masks, p2.stages.masks, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spmv", ["benes", "benes_fused"])
def test_disk_cache_roundtrip_bit_identical(tmp_path, monkeypatch, spmv):
    cache = tmp_path / "plans"
    monkeypatch.setenv("FU_PLAN_CACHE", str(cache))
    topo = fat_tree(8, seed=0)
    k1 = _kernel(topo, spmv)
    files = list(cache.iterdir())
    assert [f.suffix for f in files] == [".npz"], "plan was not persisted"
    sb._plan_cache.clear()                      # force the disk path
    k2 = _kernel(topo, spmv)
    p1, p2 = k1.arrays.ns_plan, k2.arrays.ns_plan
    if spmv == "benes_fused":
        # only the base routing is stored; the passes are planned again
        assert [dataclasses.astuple(ps) for ps in p1.fused.passes] == [
            dataclasses.astuple(ps) for ps in p2.fused.passes]
        p1, p2 = p1.base, p2.base
    _assert_same_plan(p1, p2)
    s1 = k1.run(k1.init_state(), 8)
    s2 = k2.run(k2.init_state(), 8)
    assert torch.equal(s1.S, s2.S) and torch.equal(s1.G, s2.G)


def test_disk_cache_disabled_and_corrupt(tmp_path, monkeypatch, caplog):
    # disabled: nothing may be written anywhere (cwd pinned to an empty
    # dir, XDG redirected so the user cache can't absorb a regression)
    work = tmp_path / "cwd"
    work.mkdir()
    xdg = tmp_path / "xdg"
    xdg.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("XDG_CACHE_HOME", str(xdg))
    monkeypatch.setenv("FU_PLAN_CACHE", "0")
    topo = fat_tree(8, seed=0)
    _kernel(topo)
    assert not list(work.iterdir()), "disabled cache wrote into cwd"
    assert not list(xdg.rglob("*.npz")), "disabled cache wrote into XDG"
    # corrupt file: warn + replan, never raise
    cache = tmp_path / "cache"
    monkeypatch.setenv("FU_PLAN_CACHE", str(cache))
    sb._plan_cache.clear()
    k = _kernel(topo)
    path = list(cache.iterdir())[0]
    path.write_bytes(b"not an npz")
    sb._plan_cache.clear()
    caplog.set_level(logging.WARNING)
    k2 = _kernel(topo)                  # replans from scratch
    assert any("replanning" in r.getMessage() for r in caplog.records)
    assert torch.equal(k.run(k.init_state(), 4).S,
                       k2.run(k2.init_state(), 4).S)


def test_default_directory_is_the_port_s_own(tmp_path):
    """Unset, the cache lives under the port's own name in
    ``$XDG_CACHE_HOME``, never JAX's directory or the source tree."""
    topo = fat_tree(6, seed=1)
    _kernel(topo)
    mine = list((tmp_path / "xdg" / "flow_updating_tpu_torch" / "plans")
                .glob("ns_v1_*.npz"))
    assert len(mine) == 1
    assert not (tmp_path / "xdg" / "flow_updating_tpu").exists()
    key0 = sb._mats_key(tuple(m.numpy() for m in _kernel(topo)
                              .arrays.mats), _kernel(topo).padded_size + 1)
    assert sb._disk_path(key0) == str(mine[0])


def test_unwritable_cache_only_warns(tmp_path, monkeypatch, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the directory should be")
    monkeypatch.setenv("FU_PLAN_CACHE", str(blocker / "plans"))
    caplog.set_level(logging.WARNING)
    k = _kernel(fat_tree(4, seed=0))
    assert any("write failed" in r.getMessage() for r in caplog.records)
    assert k.run(k.init_state(), 3).t == 3


def test_a_jax_written_cache_file_loads_in_the_port(tmp_path, monkeypatch):
    """The layout is JAX's: pointed at one directory, the port loads the
    file JAX wrote for the same ELL matrices (routed by JAX's planner)
    and its neighbor sums equal the port's own routing bit for bit."""
    cache = tmp_path / "shared"
    monkeypatch.setenv("FU_PLAN_CACHE", str(cache))
    jk = jsync.NodeKernel(jgen.fat_tree(8, seed=0), JaxConfig.fast(
        variant="collectall", kernel="node", spmv="benes", dtype="float64"))
    assert len(list(cache.iterdir())) == 1
    topo = fat_tree(8, seed=0)
    loaded = _kernel(topo)
    assert len(list(cache.iterdir())) == 1      # read, nothing new written
    _assert_same_plan(loaded.arrays.ns_plan, jk.arrays.ns_plan)
    monkeypatch.setenv("FU_PLAN_CACHE", "0")
    sb._plan_cache.clear()
    routed = _kernel(topo)
    a = loaded.run(loaded.init_state(), 6)
    b = routed.run(routed.init_state(), 6)
    assert torch.equal(a.S, b.S) and torch.equal(a.A_prev, b.A_prev)


def test_in_process_cache_stays_bounded(monkeypatch):
    monkeypatch.setenv("FU_PLAN_CACHE", "0")
    for n in range(12, 24):
        mats = (np.arange(n, dtype=np.int32).reshape(-1, 1)[::-1].copy(),)
        sb.plan_neighbor_sum(mats, n + 1)
    assert len(sb._plan_cache) == 8
