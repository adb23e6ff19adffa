"""Hygiene of the PyTorch port: it imports no JAX stack and nothing of the
JAX package (the data-parallel modules included), its entry points run on
the CUDA device unless the caller asks for the CPU, and no test that starts
ranks leaves a child process behind."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cyclegan_tpu_torch import export, serve
from cyclegan_tpu_torch.kernels import instance_norm_act, residual_block_fused
from cyclegan_tpu_torch.models.generators import define_Gen


def test_port_imports_without_jax():
    """Import every module of the port with jax/flax/optax/orbax poisoned,
    then check no cyclegan_tpu module was loaded. The key test is exact or
    prefix-with-dot: a substring test would also match cyclegan_tpu_torch."""
    code = r"""
import sys
for name in ("jax", "flax", "optax", "orbax"):
    sys.modules[name] = None  # poison: any import of them raises ImportError
import importlib, pkgutil
import cyclegan_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cyclegan_tpu_torch.__path__,
                                              "cyclegan_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
leaked = [k for k in sys.modules
          if k == "cyclegan_tpu" or k.startswith("cyclegan_tpu.")]
assert not leaked, f"JAX package modules loaded: {leaked}"
print("OK", len(mods))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 15  # every module was walked


def _artifact(tmp_path):
    G = define_Gen(3, 5, 8, "resnet_2blocks", head="none",
                   generator=torch.Generator().manual_seed(0))
    return export.export_generator(G, str(tmp_path / "m"), gen_net="resnet_2blocks",
                                   ngf=8, num_classes=5, in_channels=3,
                                   crop_hw=(32, 32), dtype="float32")


def test_build_predictor_default_device_needs_cuda(tmp_path, monkeypatch):
    """No device given means the CUDA device; without one the predictor
    refuses instead of running on the CPU."""
    art = _artifact(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_predictor(art)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_predictor(art, device="cuda")
    predict, info = serve.build_predictor(art, device="cpu")
    assert info["device"] == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; on a device
    with no kernel it raises (no silent fallback)."""
    x = torch.empty((1, 4, 4, 32), device="meta")
    w = torch.empty((3, 3, 32, 32), device="meta")
    b = torch.empty((32,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        instance_norm_act(x, None, 1e-5, "relu")
    with pytest.raises(ValueError, match="no kernel"):
        residual_block_fused(x, w, b, w, b)


def test_parallel_modules_import_without_jax():
    """The data-parallel modules import with the JAX stack poisoned."""
    code = r"""
import sys
for name in ("jax", "flax", "optax", "orbax"):
    sys.modules[name] = None
import cyclegan_tpu_torch.parallel
from cyclegan_tpu_torch.parallel import distributed, mesh
assert not [k for k in sys.modules if k == "cyclegan_tpu" or k.startswith("cyclegan_tpu.")]
print("OK", mesh.make_mesh(device="cpu").world, distributed.process_info())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.split() == ["OK", "1", "(0,", "1)"], r.stderr[-2000:]


def test_port_tools_import_without_jax():
    """The port's checkpoint bridge, HTTP load bench, soak summary, slab
    norm bench and span trace import with the JAX stack poisoned and load
    nothing of the JAX package: they run where the port runs, which has no
    JAX."""
    code = r"""
import sys
for name in ("jax", "flax", "optax", "orbax"):
    sys.modules[name] = None
import tools.torch_import_checkpoint, tools.torch_export_checkpoint, tools.torch_http_bench
import tools.torch_soak_summary, tools.torch_slab_norm_bench, tools.torch_span_trace
assert not [k for k in sys.modules if k == "cyclegan_tpu" or k.startswith("cyclegan_tpu.")]
print("OK")
"""
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(root))
    assert r.returncode == 0 and r.stdout.split() == ["OK"], r.stderr[-2000:]


SPAWNS_RANKS = ("launch_local(", '"--num_devices", "2"', '"--gpu_ids"')


def test_files_that_spawn_ranks_check_no_child_is_left():
    """Every port test file that starts ranks checks, after each of its
    tests, that no child process of the test is still alive."""
    tests = Path(__file__).resolve().parent
    spawning = [p for p in sorted(tests.glob("test_torch_*.py")) if p != Path(__file__).resolve()
                and any(s in p.read_text() for s in SPAWNS_RANKS)]
    assert {p.name for p in spawning} >= {"test_torch_parallel.py", "test_torch_multiprocess.py"}
    for p in spawning:
        text = p.read_text()
        assert re.search(r"@pytest\.fixture\(autouse=True\)\ndef _no_child_left_behind\(\):\n"
                         r"    yield\n    assert multiprocessing\.active_children\(\) == \[\]",
                         text), p.name
