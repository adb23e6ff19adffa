"""Hygiene of the PyTorch port: it imports no JAX stack and nothing of the
JAX package, and its entry points run on the CUDA device unless the caller
asks for the CPU."""

import subprocess
import sys

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
