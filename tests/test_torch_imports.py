"""The port stands alone: no JAX, nothing of the JAX package, no quiet CPU.

1. A static scan of every module of ``flow_updating_tpu_torch`` and of
   ``chip_smoke.py``: no import of ``jax`` (or ``jaxlib``) and none of the
   package ``flow_updating_tpu`` or its submodules.  The match is on whole
   dotted names — ``flow_updating_tpu_torch`` itself starts with
   ``flow_updating_tpu`` and must not trip it.
2. A subprocess with ``jax`` and ``flow_updating_tpu`` made unimportable
   imports every port module and runs a small round on the CPU.
3. Without a CUDA card, every entry point called without ``device=``
   raises instead of running on the host.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "flow_updating_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flow_updating_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imported_names(path: str) -> list:
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            names.append(node.args[0].value)
    return names


def test_forbidden_name_match_is_not_a_prefix_match():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("flow_updating_tpu")
    assert _forbidden("flow_updating_tpu.models.sync")
    assert not _forbidden("flow_updating_tpu_torch")
    assert not _forbidden("flow_updating_tpu_torch.models.sync")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_jax_package_imports(path):
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_runs_with_jax_unimportable():
    code = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flow_updating_tpu"):
    sys.modules[blocked] = None          # any import of it now fails
import flow_updating_tpu_torch as p
for mod in pkgutil.walk_packages(p.__path__, "flow_updating_tpu_torch."):
    if not mod.name.endswith("__main__"):
        importlib.import_module(mod.name)
from flow_updating_tpu_torch.topology.generators import ring
e = p.Engine(config=p.RoundConfig.fast(kernel="node", spmv="banded_fused"),
             device="cpu").set_topology(ring(64, 2)).build()
e.run_rounds(200)
print(e.convergence_report()["rmse"])
"""
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout.strip().splitlines()[-1]) < 1e-4


def test_entry_points_refuse_the_cpu_unless_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
    from flow_updating_tpu_torch.cli import main
    from flow_updating_tpu_torch.topology.generators import ring

    cfg = RoundConfig.fast(kernel="node", spmv="pallas")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NodeKernel(ring(16), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(config=cfg)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["run", "--generator", "ring:16", "--kernel", "node",
              "--fire-policy", "every_round", "--rounds", "3"])
    # asked for explicitly, the host runs the plain versions
    k = NodeKernel(ring(16), cfg, device="cpu")
    assert k.arrays.value.device.type == "cpu"
    assert np.isfinite(k.estimates(k.run(k.init_state(), 3))).all()
