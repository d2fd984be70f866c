"""The edge kernel through the port's ``Engine`` and ``run`` CLI against the
JAX package's.

The README's first quick-start command — the faithful collect-all run on
the bundled small6 SimGrid platform and deployment — and ``--kernel edge``
runs with the segment/delivery layouts, message loss and the FIFO knobs
must print JAX's JSON keys with its values.  The CLI runs float32; JAX's
``run`` command runs without ``jax_enable_x64`` (so its loss draws are
float32, as the port's are at float32), which the tests reproduce with
``jax.enable_x64(False)``.  The printed statistics are held to a relative
1e-3 above a floor: 1e-7 on the generated rings, and 16 float32 ulps of
the mean (3.05e-5) on small6, whose run ends at the float32 noise floor
(statistics ~1e-5 that differ with the reductions' order).  There the
per-node averages the watcher logs are held to 8 ulps of the mean.
The float64 Engine run is held to 1e-9.
"""

import ast
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL6 = (os.path.join(ROOT, "examples/platforms/small6.xml"),
          os.path.join(ROOT, "examples/deployments/small6_actors.xml"))
RTOL = 1e-3
ATOL = 1e-7
ULP30 = float(np.spacing(np.float32(30.0)))  # small6's mean is 30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _both(capsys, flags, atol=ATOL):
    with jax.enable_x64(False):
        assert jax_main(["run", "--backend", "cpu", *flags]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_main(["run", "--device", "cpu", *flags]) == 0
    prep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(jrep) <= set(prep)
    for key in ("t", "nodes", "edges", "variant", "fire_policy",
                "true_mean"):
        assert prep[key] == jrep[key], key
    for key in ("rmse", "max_abs_err", "mass_residual",
                "antisymmetry_residual"):
        assert abs(prep[key] - jrep[key]) <= RTOL * abs(jrep[key]) + atol, \
            (key, prep[key], jrep[key])
    return jrep, prep


def _last_avgs(caplog, logger):
    """The per-node ``last_avg`` of the watcher's last log line."""
    lines = [r.getMessage() for r in caplog.records
             if r.name == logger and "] last_avg{" in r.getMessage()]
    return ast.literal_eval(lines[-1].split("last_avg", 1)[1])


def test_readme_small6_faithful_run_matches_jax(capsys, caplog):
    caplog.set_level(logging.INFO)
    flags = ["--platform", SMALL6[0], "--deployment", SMALL6[1],
             "--variant", "collectall", "--until", "300"]
    jrep, prep = _both(capsys, flags, atol=16 * ULP30)
    assert prep["t"] == 300 and prep["fire_policy"] == "reference"
    assert prep["rmse"] < 1e-4
    javg = _last_avgs(caplog, "flow_updating_tpu.engine")
    pavg = _last_avgs(caplog, "flow_updating_tpu_torch.engine")
    assert list(pavg) == list(javg) and len(pavg) == 6
    np.testing.assert_allclose(list(pavg.values()), list(javg.values()),
                               rtol=8 * ULP30 / 30.0, atol=0)


@pytest.mark.parametrize("extra", [
    ["--variant", "pairwise", "--segment", "benes_fused", "--delivery",
     "benes_fused", "--drop-rate", "0.1"],
    ["--segment", "ell", "--delivery", "scatter", "--drop-rate", "0.05",
     "--drain", "2", "--timeout", "20", "--pending-depth", "3",
     "--delay-depth", "2"],
    ["--variant", "pairwise", "--fire-policy", "every_round", "--segment",
     "benes"],
])
def test_cli_edge_kernel_runs_match_jax(capsys, extra):
    flags = ["--generator", "ring:64:2", "--rounds", "200", "--kernel",
             "edge", *extra]
    jrep, prep = _both(capsys, flags)
    assert prep["device"] == "cpu"


def test_cli_refuses_contention_and_fidelity(capsys):
    """``--contention`` and ``--fidelity`` used to exit naming A3; they
    run now and print JAX's report (the README's small6 run with each)."""
    base = ["--platform", SMALL6[0], "--deployment", SMALL6[1],
            "--rounds", "200"]
    for flag in (["--contention", "--latency-scale", "100"],
                 ["--fidelity"]):
        jrep, prep = _both(capsys, [*base, *flag], atol=16 * ULP30)
        assert prep["t"] == 200


def test_engine_small6_faithful_matches_jax():
    def drive(make, cfg, **kw):
        seen = []
        e = make(config=cfg, **kw)
        e.load_platform(SMALL6[0]).register_actor("peer")
        e.load_deployment(SMALL6[1])
        e.add_watcher(run_until=300, time_interval=25,
                      callback=lambda eng: seen.append(eng.clock))
        e.run_until(400)
        return e, seen

    jeng, jseen = drive(JaxEngine, JaxConfig.reference("collectall",
                                                       dtype="float64"))
    peng, pseen = drive(Engine, RoundConfig.reference("collectall",
                                                      dtype="float64"),
                        device="cpu")
    assert pseen == jseen and peng.clock == jeng.clock == 400.0
    jrep, prep = jeng.convergence_report(), peng.convergence_report()
    assert prep.keys() == jrep.keys()
    assert prep["t"] == jrep["t"] == 300
    for key in ("rmse", "max_abs_err", "mass_residual",
                "antisymmetry_residual"):
        assert abs(prep[key] - jrep[key]) <= 1e-9, key
    np.testing.assert_allclose(peng.estimates(), jeng.estimates(),
                               rtol=1e-9, atol=1e-9)
    pg, jg = peng.global_values(), jeng.global_values()
    assert pg["value"] == jg["value"]
    np.testing.assert_allclose(list(pg["last_avg"].values()),
                               list(jg["last_avg"].values()), rtol=1e-9,
                               atol=1e-9)
