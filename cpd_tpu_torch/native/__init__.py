"""The port's native host library: C++ eXmY numerics and the fused
augment, built at first use and bound with ctypes (port of
`cpd_tpu/native/`, with its own copy of the sources).

``g++ -O2 -shared -fPIC -pthread -ffp-contract=off`` compiles
``quant_native.cpp`` and ``augment_native.cpp`` into
``build/cpu/<hash of sources and flags>/libcpd_native.so`` at the root
of the checkout (``build/`` is git-ignored): an edited source rebuilds,
an unchanged one is reused.  The build writes a temporary file and
renames it, so processes that race to build are safe.  Where no compiler
works, `available()` is False and the callers keep their numpy paths.

Public surface, numpy in and numpy out (pure, no in-place mutation):

* `float_quantize_np(x, exp, man)` — the elementwise RTNE eXmY cast;
* `quant_gemm_np(a, b, exp, man)` — the faithful Kahan eXmY GEMM;
* `ordered_sum_np(stacked, exp, man, kahan)` — the rank-ordered
  quantized reduction over axis 0;
* `fused_augment_np(...)` — Crop -> FlipLR [-> Cutout] over a padded
  NHWC dataset in one threaded pass (`data.augment.TransformPipeline`).

Each is bitwise its torch counterpart (`quant.numerics.cast_body`,
`ops.qgemm.qgemm_faithful_ref`, the numpy transform chain;
tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

__all__ = ["available", "build", "load", "float_quantize_np",
           "quant_gemm_np", "ordered_sum_np", "fused_augment_np",
           "CXX_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = (os.path.join(_HERE, "quant_native.cpp"),
         os.path.join(_HERE, "augment_native.cpp"))
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _so_path() -> str:
    """The library's path for these sources and flags."""
    h = hashlib.sha256()
    for path in _SRCS:
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    root = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                        "cpu", h.hexdigest()[:16])
    return os.path.join(root, "libcpd_native.so")


def build(force: bool = False) -> Optional[str]:
    """Compile the library unless it is built; its path, or None when no
    compiler works."""
    so = _so_path()
    if os.path.exists(so) and not force:
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    for cxx in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if not cxx:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
        os.close(fd)
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *_SRCS], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, so)
            return so
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.unlink(tmp)
    return None


def load() -> Optional[ctypes.CDLL]:
    """Build if needed and load, once per process; None when
    unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:              # built for another host: build it anew
        so = build(force=True)
        if so is None:
            return None
        lib = ctypes.CDLL(so)
    i64, i32 = ctypes.c_int64, ctypes.c_int
    fptr = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    bptr = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.cpd_cast_one.restype = ctypes.c_float
    lib.cpd_cast_one.argtypes = [ctypes.c_float, i32, i32]
    lib.cpd_quantize.restype = None
    lib.cpd_quantize.argtypes = [fptr, fptr, i64, i32, i32]
    lib.cpd_qgemm.restype = None
    lib.cpd_qgemm.argtypes = [fptr, fptr, fptr, i64, i64, i64, i32, i32]
    lib.cpd_ordered_sum.restype = None
    lib.cpd_ordered_sum.argtypes = [fptr, fptr, i64, i64, i32, i32, i32]
    lib.cpd_fused_augment.restype = None
    lib.cpd_fused_augment.argtypes = [
        fptr, iptr, i64, i64, i64, i64, iptr, iptr, i64, i64, bptr,
        iptr, iptr, i64, i64, fptr, i64]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise NotImplementedError(
            "the native library is unavailable (no C++ compiler worked); "
            "use cpd_tpu_torch.quant.float_quantize")
    return lib


def float_quantize_np(x: np.ndarray, exp: int, man: int) -> np.ndarray:
    """Elementwise RTNE eXmY cast on the host, any shape."""
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    lib.cpd_quantize(x.reshape(-1), out.reshape(-1), x.size, exp, man)
    return out


def quant_gemm_np(a: np.ndarray, b: np.ndarray, exp: int, man: int
                  ) -> np.ndarray:
    """a (M, K) @ b (K, N) with the faithful Kahan eXmY accumulator."""
    lib = _require()
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M,K)x(K,N), got {a.shape} x {b.shape}")
    m, k = a.shape
    n = b.shape[1]
    out = np.empty((m, n), np.float32)
    lib.cpd_qgemm(a, b, out, m, n, k, exp, man)
    return out


def ordered_sum_np(stacked: np.ndarray, exp: int, man: int,
                   kahan: bool = False) -> np.ndarray:
    """Rank-ordered quantized reduction over axis 0 of (W, ...)."""
    lib = _require()
    stacked = np.ascontiguousarray(stacked, np.float32)
    w = stacked.shape[0]
    n = stacked.size // max(w, 1)
    out = np.empty(stacked.shape[1:], np.float32)
    lib.cpd_ordered_sum(stacked.reshape(w, -1), out.reshape(-1), w, n,
                        exp, man, int(kahan))
    return out


def fused_augment_np(data: np.ndarray, indices: np.ndarray,
                     crop_y: np.ndarray, crop_x: np.ndarray,
                     oh: int, ow: int, flip: np.ndarray,
                     cut_y: Optional[np.ndarray] = None,
                     cut_x: Optional[np.ndarray] = None,
                     cut_h: int = 0, cut_w: int = 0,
                     n_threads: int = 0) -> np.ndarray:
    """Fused crop -> flip -> cutout over a padded fp32 NHWC dataset.

    ``crop_*``, ``flip`` and ``cut_*`` are per-DATASET-sample choices
    (`TransformPipeline.resample`'s layout); ``indices`` selects the
    batch.  Bitwise the numpy transform chain (pure copies and zeros).
    ``n_threads`` 0: the host's hardware concurrency."""
    lib = _require()
    data = np.ascontiguousarray(data, np.float32)
    _, ih, iw, ch = data.shape
    indices = np.ascontiguousarray(indices, np.int64)
    if not cut_h:
        # unread when cut_h == 0; one element satisfies the signature
        cut_y = cut_x = np.zeros(1, np.int64)
    out = np.empty((indices.size, oh, ow, ch), np.float32)
    lib.cpd_fused_augment(
        data.reshape(-1), indices, indices.size, ih, iw, ch,
        np.ascontiguousarray(crop_y, np.int64),
        np.ascontiguousarray(crop_x, np.int64), oh, ow,
        np.ascontiguousarray(flip, np.uint8),
        np.ascontiguousarray(cut_y, np.int64),
        np.ascontiguousarray(cut_x, np.int64),
        cut_h, cut_w, out.reshape(-1), n_threads)
    return out
