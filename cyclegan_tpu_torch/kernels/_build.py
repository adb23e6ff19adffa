"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``build/lib<name>-<hash>.so``, where the hash covers the source, the shared
headers and the compiler flags: an edited source builds anew, an unchanged
one is reused. Building happens at first use (or all at once, in parallel,
through :func:`build_all`), never at import. The toolkit is found through
``CUDA_HOME`` (default ``/usr/local/cuda``) or ``nvcc`` on ``PATH``.

Every C entry returns the ``cudaError_t`` of its launches; :func:`call`
runs one entry, raises on anything but 0 and counts the call in
:data:`launches` (by entry name).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("instance_norm", "resblock", "resblock_chunked", "conv_dw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Element-type codes of the C interface (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VOIDP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry, by library.
SIGNATURES = {
    "instance_norm": {
        "cg_instance_norm_act": [_VOIDP] * 5 + [_INT] * 7 + [_FLOAT] + [_INT] * 3
        + [_VOIDP],
        "cg_instance_norm_act_bwd": [_VOIDP] * 6 + [_INT] * 11 + [_VOIDP],
        "cg_instance_norm_partials": [_VOIDP] * 2 + [_INT] * 2 + [_VOIDP] + [_INT] * 8
        + [_VOIDP],
        "cg_instance_norm_slab_apply": [_VOIDP] * 5 + [_INT] * 8 + [_FLOAT] + [_INT] * 2
        + [_VOIDP],
        "cg_instance_norm_bwd_partials": [_VOIDP] * 5 + [_INT] * 2 + [_VOIDP] + [_INT] * 9
        + [_VOIDP],
        "cg_instance_norm_bwd_slab_apply": [_VOIDP] * 6 + [_INT] + [_VOIDP] + [_INT] * 9
        + [_VOIDP],
    },
    "resblock": {
        "cg_conv3x3_reflect": [_VOIDP] * 4 + [_INT] * 10 + [_VOIDP],
        "cg_conv3x3_reflect_dgrad": [_VOIDP] * 5 + [_INT] * 12 + [_VOIDP],
    },
    "resblock_chunked": {
        "cg_chunked_in_fwd": [_VOIDP] * 5 + [_INT] * 8 + [_FLOAT] + [_INT] * 2 + [_VOIDP],
        "cg_chunked_in_vjp": [_VOIDP] * 6 + [_INT] * 10 + [_VOIDP],
    },
    "conv_dw": {
        "cg_bf16_parts": [_VOIDP] * 2 + [_INT] * 7 + [_VOIDP],
        "cg_conv_dw": [_VOIDP] * 4 + [_INT] * 12 + [_VOIDP],
    },
}

# Successful calls of each C entry: the port's launch counter (a wrapper
# may make several entry calls; a test reads the delta of the entries the
# route it holds calls).
launches: collections.Counter = collections.Counter()
# Calls by the form of the operand that sets a kernel's route: the norm VJP
# (``("in_bwd", form)``) by its dx, written as ``"float32"``,
# ``"bfloat16"`` or the ``"parts"`` the gradient convolutions multiply; the
# weight gradient (``("wgrad", form)``) by its input, ``"padded"`` or read
# through ``"reflect"`` indexing.
forms: collections.Counter = collections.Counter()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            f"kernels of cyclegan_tpu_torch build only on a machine with "
            f"the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    ``(process, tmp_path, target)`` or None."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, target


def _finish(name: str, started) -> str:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    target.with_suffix(".log").write_text(out)
    os.replace(tmp, target)  # atomic: a concurrent builder sees old or new
    return out


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every named source at once (one nvcc each, in parallel).
    Returns each new build's compiler output (ptxas register and spill
    lines); sources already built map to their saved log."""
    started = {n: _start(n) for n in names}
    logs = {}
    for n, s in started.items():
        if s is None:
            log = library_path(n).with_suffix(".log")
            logs[n] = log.read_text() if log.exists() else ""
        else:
            logs[n] = _finish(n, s)
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err}")


@functools.cache
def _entry(name: str, fn: str):
    return getattr(load(name), fn)


def call(name: str, fn: str, *args) -> None:
    """Run C entry ``fn`` of ``csrc/<name>.cu`` (built first if needed),
    raise if it returns a CUDA error, and count it in :data:`launches`."""
    check(_entry(name, fn)(*args), fn)
    launches[fn] += 1


def check_same_device(name: str, *tensors: torch.Tensor) -> None:
    """What every C entry assumes of its tensors: contiguous, on one
    device, of a type it takes, 16-byte aligned."""
    for t in tensors:
        if not t.is_contiguous() or t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors must be contiguous on one device")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


# Scratch memory of the kernels (split-K partials, padded gradients), one
# buffer per (device, stream), grown on demand and reused by every call on
# that stream: the stream orders each use after the previous one.
_scratch: dict = {}


def scratch_ptr(nbytes: int, t: torch.Tensor, stream: int) -> int:
    """Device address of at least ``nbytes`` of scratch on ``t``'s device
    for kernels launched on ``stream``; valid until the next call."""
    key = (t.device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _scratch[key] = torch.empty(nbytes, dtype=torch.uint8, device=t.device)
    return buf.data_ptr()


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle (the
    raw handle PyTorch's own code generators read: no Stream object is
    built, which costs microseconds of host time per launch).
    ``torch._C._cuda_getCurrentRawStream`` is private: PyTorch 2.11 has it,
    and every card test that launches a kernel goes through this call, so a
    version without it fails them; ``torch.cuda.current_stream(dev)
    .cuda_stream`` is the public, slower equivalent."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
