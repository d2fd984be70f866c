"""The port's mesh (``parallel/mesh.py``) against the JAX package's.

The JAX mesh is a ``jax.sharding.Mesh`` over the ``'nodes'`` axis of the
suite's 8 virtual CPU devices; the port's is the ordered shard devices of
one process, all on the host with ``device='cpu'`` (on the card, shard
``s`` goes to ``cuda:{s % device_count}`` — checked in
``tests/test_torch_cuda.py``).  Both name the same axis and count the same
shards, and the port's sharded round runs the same on any shard count
that the JAX mesh accepts.
"""

import numpy as np
import pytest
import torch

from flow_updating_tpu.parallel.mesh import NODE_AXIS as JAX_NODE_AXIS
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.parallel import NODE_AXIS, Mesh, make_mesh
from flow_updating_tpu_torch.topology.generators import ring


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_cpu_mesh_matches_jax_mesh_shape(shards):
    jm = jax_make_mesh(shards)
    pm = make_mesh(shards, device="cpu")
    assert isinstance(pm, Mesh)
    assert pm.size == jm.devices.size == shards
    assert pm.axis == NODE_AXIS == JAX_NODE_AXIS == jm.axis_names[0]
    assert pm.devices == (torch.device("cpu"),) * shards
    assert pm.streams == (None,) * shards
    assert pm.device_type == "cpu"


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        make_mesh(2, device="meta")
    if not torch.cuda.is_available():
        # the default is the card, as for every entry point
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(2)


def test_cli_shards_on_the_host_needs_asking():
    flags = ["run", "--generator", "ring:64:2", "--kernel", "node",
             "--fire-policy", "every_round", "--spmv", "banded_fused",
             "--shards", "2", "--rounds", "3"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            port_main(flags)
    assert port_main([*flags, "--device", "cpu"]) == 0


@pytest.mark.parametrize("shards", [2, 3, 5, 8])
def test_any_shard_count_runs_and_matches_one_device(shards):
    """The ring's sharded estimates equal the single-device
    ``banded_fused`` run, whatever the shard count (float32)."""
    topo = ring(3000, 2)
    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused",
                           dtype="float32")
    one = Engine(config=cfg, device="cpu").set_topology(topo).build()
    one.run_rounds(40)
    many = Engine(config=cfg, mesh=make_mesh(shards, device="cpu"),
                  halo="overlap", device="cpu").set_topology(topo).build()
    many.run_rounds(40)
    assert np.array_equal(many.estimates(), one.estimates())
    assert many.convergence_report() == one.convergence_report()
