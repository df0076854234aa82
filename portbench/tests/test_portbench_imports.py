"""No run loads JAX or the JAX package, and the reference loads nothing
of the port. Module names are compared whole, by their top-level part:
the port's own name begins with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from portbench.harness.cell import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]
PORT = "iwae_replication_project_tpu_torch"

_LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in list(sys.modules)}})))
"""


def _top_level_after(body: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          _LOADED.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_port_or_jax():
    got = _top_level_after(
        "import portbench.reference.iwae, portbench.reference.draws")
    assert not got & (set(FORBIDDEN) | {PORT})


def test_a_dry_run_loads_the_port_and_no_jax():
    got = _top_level_after(
        "import importlib.util, torch\n"
        "torch.set_num_threads(2)\n"
        "spec = importlib.util.spec_from_file_location('r', "
        "'portbench/run.py')\n"
        "r = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(r)\n"
        "assert r.main(['--workload', 'iwae1l-train', '--seed', '3', "
        "'--seconds', '0.1'], dry={'traffic': {'n_train': 300}}) == 0")
    assert PORT in got
    assert not got & set(FORBIDDEN)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench.harness import cell
    monkeypatch.setitem(sys.modules, PORT + "_fake.sub", object())
    assert cell.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert cell.loaded_forbidden() == ["jax"]
