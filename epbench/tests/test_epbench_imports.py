"""No module that the harness loads is JAX, jaxlib, flax or the JAX
package (``repro``), compared by whole top-level names; the plain
reference imports nothing of the port either."""
from __future__ import annotations

import ast
import subprocess
import sys

from epbench import common

LOADS = ("import epbench.run, epbench.control, epbench.checks, "
         "epbench.trace, epbench.faults, epbench.traffic.decode, "
         "epbench.traffic.train, "
         "epbench.reference.model, epbench.reference.train; "
         "from epbench import common; "
         "from repro_torch.models import model_zoo; "
         "from repro_torch.launch import serve; "
         "from repro_torch.training import train_loop; "
         "[common.load_module('metrics', m['name']) "
         "for m in common.benchmark()['per_layer']]; "
         "import sys; print(sorted({n.split('.')[0] for n in sys.modules}))")


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert common.forbidden_modules() == ["repro"]


def test_harness_loads_no_forbidden_module():
    out = subprocess.run(
        [sys.executable, "-c", LOADS], capture_output=True, text=True,
        cwd=common.CHECKOUT,
        env={"PYTHONPATH": f"{common.CHECKOUT / 'src'}:{common.CHECKOUT}",
             "PATH": "/usr/bin:/bin"}, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & set(common.FORBIDDEN), tops & set(common.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in (common.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("repro", "repro_torch",
                                               "jax"), (path, n)
