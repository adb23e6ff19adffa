"""No module a run loads is JAX or the JAX package (top-level names
compared whole: ``cyclegan_tpu_torch`` begins with ``cyclegan_tpu``), and
the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

BENCH_DIR = harness.BENCH_DIR


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax():
    for f in BENCH_DIR.rglob("*.py"):
        assert not top_level_imports(f) & set(harness.FORBIDDEN), f


def test_reference_imports_nothing_of_the_port():
    for f in (BENCH_DIR / "reference").rglob("*.py"):
        assert "cyclegan_tpu_torch" not in top_level_imports(f), f


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=harness.ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    from portbench.tests import tiny

    code = ("import portbench.tests.tiny as t\nfrom portbench import harness\n"
            "import torch\ntorch.set_num_threads(2)\n"
            f"for c in {list(tiny.TRAIN_CELLS + tiny.SERVE_CELLS)!r}:\n"
            "    harness.run_cell(c, 7, 0.2, True, device='cpu', overrides=t.overrides(c))\n"
            "    harness.run_cell(c, 7, 0.2, False, device='cpu', overrides=t.overrides(c))\n")
    loaded = _loaded_after(code)
    assert "cyclegan_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    families = sorted(f.stem for f in (BENCH_DIR / "reference").glob("gen_*.py"))
    assert {"gen_resnet", "gen_unet"} <= set(families)
    loaded = _loaded_after("import portbench.reference.train, portbench.reference.serve, "
                           "portbench.reference.precision"
                           + "".join(f", portbench.reference.{f}" for f in families))
    assert not loaded & {"cyclegan_tpu_torch", *harness.FORBIDDEN}
