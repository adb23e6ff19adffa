"""ctypes binding of the native pixel library (``native/cgtpu_data.cpp``).

The port's own copy of ``cyclegan_tpu/data/native.py`` (that package's
``__init__`` imports JAX). It loads ``native/libcgtpu_data.so`` of the
checkout, building it with ``make -C native`` first if it is absent, and
caches the handle. ``CYCLEGAN_TPU_NO_NATIVE`` turns it off. Every entry
point has a numpy path, taken when the library is missing, and the two are
bit-identical: the augment parameters are drawn in Python, only the pixel
work crosses the boundary. This is host code; no device kernel is here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcgtpu_data.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False

_int_p = ctypes.POINTER(ctypes.c_int)
_u8_p = ctypes.POINTER(ctypes.c_uint8)
_f32_p = ctypes.POINTER(ctypes.c_float)
_i32_p = ctypes.POINTER(ctypes.c_int32)


def _declare(lib: ctypes.CDLL) -> None:
    lib.cgtpu_version.argtypes = []
    lib.cgtpu_version.restype = ctypes.c_int
    lib.cgtpu_crop_flip_normalize_batch.argtypes = [
        ctypes.c_void_p, _int_p, _int_p, ctypes.c_int, _int_p, _int_p, _u8_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32_p]
    lib.cgtpu_crop_flip_normalize_batch.restype = None
    lib.cgtpu_crop_flip_label_batch.argtypes = [
        ctypes.c_void_p, _int_p, _int_p, _int_p, _int_p, _u8_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32_p]
    lib.cgtpu_crop_flip_label_batch.restype = None
    lib.cgtpu_one_hot.argtypes = [_i32_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32_p]
    lib.cgtpu_one_hot.restype = None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("CYCLEGAN_TPU_NO_NATIVE"):
            _lib_failed = True
            return None
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True, check=True,
                               timeout=120)
            lib = ctypes.CDLL(_LIB_PATH)
            _declare(lib)
            if lib.cgtpu_version() != 1:
                raise OSError(f"{_LIB_PATH}: unexpected version {lib.cgtpu_version()}")
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _ptrs(arrays: list[np.ndarray]):
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def _ints(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.int32)


def crop_flip_normalize_batch(imgs: list[np.ndarray], tops: np.ndarray, lefts: np.ndarray,
                              flips: np.ndarray, crop_hw: tuple[int, int]) -> np.ndarray:
    """Crop, flip and normalize a batch of HWC uint8 images in one call:
    (n, crop_h, crop_w, C) float32 in [-1, 1]."""
    ch, cw = crop_hw
    c, n = imgs[0].shape[2], len(imgs)
    out = np.empty((n, ch, cw, c), np.float32)
    lib = _load()
    if lib is None:
        for i, img in enumerate(imgs):
            crop = img[tops[i]:tops[i] + ch, lefts[i]:lefts[i] + cw]
            if flips[i]:
                crop = crop[:, ::-1]
            out[i] = crop.astype(np.float32) / 127.5 - 1.0
        return out
    imgs = [np.ascontiguousarray(im, np.uint8) for im in imgs]
    hs, ws = _ints([im.shape[0] for im in imgs]), _ints([im.shape[1] for im in imgs])
    tops, lefts = _ints(tops), _ints(lefts)
    flips = np.ascontiguousarray(flips, np.uint8)
    lib.cgtpu_crop_flip_normalize_batch(
        _ptrs(imgs), hs.ctypes.data_as(_int_p), ws.ctypes.data_as(_int_p), c,
        tops.ctypes.data_as(_int_p), lefts.ctypes.data_as(_int_p),
        flips.ctypes.data_as(_u8_p), ch, cw, n, out.ctypes.data_as(_f32_p))
    return out


def crop_flip_label_batch(labs: list[np.ndarray], tops: np.ndarray, lefts: np.ndarray,
                          flips: np.ndarray, crop_hw: tuple[int, int]) -> np.ndarray:
    """Crop and flip a batch of HW uint8 label maps: (n, crop_h, crop_w) int32."""
    ch, cw = crop_hw
    n = len(labs)
    out = np.empty((n, ch, cw), np.int32)
    lib = _load()
    if lib is None:
        for i, lab in enumerate(labs):
            crop = lab[tops[i]:tops[i] + ch, lefts[i]:lefts[i] + cw]
            if flips[i]:
                crop = crop[:, ::-1]
            out[i] = crop.astype(np.int32)
        return out
    labs = [np.ascontiguousarray(lb, np.uint8) for lb in labs]
    hs, ws = _ints([lb.shape[0] for lb in labs]), _ints([lb.shape[1] for lb in labs])
    tops, lefts = _ints(tops), _ints(lefts)
    flips = np.ascontiguousarray(flips, np.uint8)
    lib.cgtpu_crop_flip_label_batch(
        _ptrs(labs), hs.ctypes.data_as(_int_p), ws.ctypes.data_as(_int_p),
        tops.ctypes.data_as(_int_p), lefts.ctypes.data_as(_int_p),
        flips.ctypes.data_as(_u8_p), ch, cw, n, out.ctypes.data_as(_i32_p))
    return out


def one_hot(labels: np.ndarray, num_classes: int, ignore_index: int = 255) -> np.ndarray:
    """(..., K) float32 one-hot; ignored pixels all zero."""
    lib = _load()
    if lib is None:
        from cyclegan_tpu_torch.data.palette import one_hot as np_one_hot

        return np_one_hot(labels, num_classes, ignore_index=ignore_index)
    flat = np.ascontiguousarray(labels, np.int32).reshape(-1)
    out = np.empty((flat.size, num_classes), np.float32)
    lib.cgtpu_one_hot(flat.ctypes.data_as(_i32_p), flat.size, num_classes, ignore_index,
                      out.ctypes.data_as(_f32_p))
    return out.reshape(labels.shape + (num_classes,))
