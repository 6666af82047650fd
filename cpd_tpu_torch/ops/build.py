"""Build and load the port's CUDA kernels.

Each kernel source under ``cpd_tpu_torch/csrc/`` is compiled by ``nvcc``
into a shared library with a plain C interface and loaded with ctypes
(no PyTorch headers, so a build takes seconds).  Libraries land in
``build/cuda/`` at the root of the checkout, one directory per hash of
the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing is built at import: the first call of a kernel
builds it, or `build_all` builds every kernel at once, one ``nvcc`` per
source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "build_all", "load_library",
           "build_dir", "build_log", "sass"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")

# kernel name -> source file under csrc/
KERNEL_SOURCES = {"serve_attn": "serve_attn.cu", "quantize": "quantize.cu",
                  "qgemm": "qgemm.cu", "flash_gqa": "flash_gqa.cu",
                  "flash_mha_tc": "flash_mha_tc.cu",
                  "flash_f32_tc": "flash_f32_tc.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def build_dir() -> str:
    """Root of the build outputs (listed in .gitignore)."""
    return os.path.join(os.path.dirname(_PKG), "build", "cuda")


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "are built from source at first use")


def _target(name: str) -> tuple:
    src = os.path.join(_CSRC, KERNEL_SOURCES[name])
    h = hashlib.sha256()
    for path in sorted(os.listdir(_CSRC)):   # headers count too
        with open(os.path.join(_CSRC, path), "rb") as fh:
            h.update(path.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}")
    return src, out_dir, os.path.join(out_dir, f"lib{name}.so")


def build_log(name: str) -> str:
    """What nvcc printed for ``name``'s library (``-Xptxas -v``:
    registers, shared memory, spills), or '' when not built here."""
    _, out_dir, _ = _target(name)
    path = os.path.join(out_dir, "nvcc.log")
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def sass(name: str) -> str:
    """The SASS of ``name``'s library (``cuobjdump -sass``, the tool beside
    nvcc), built first if it is not yet."""
    lib = build_all([name])[name]
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def build_all(names=None) -> dict:
    """Compile every kernel not yet built, one nvcc each, in parallel.
    Returns name -> library path; raises with nvcc's output on failure."""
    names = list(KERNEL_SOURCES) if names is None else list(names)
    procs = {}
    libs = {}
    for name in names:
        src, out_dir, lib = _target(name)
        libs[name] = lib
        if os.path.exists(lib):
            continue
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        log = open(os.path.join(out_dir, "nvcc.log"), "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=log,
            stderr=subprocess.STDOUT), log, tmp, lib)
    failed = []
    for name, (proc, log, tmp, lib) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (nvcc rc {rc}):\n{build_log(name)}")
        else:
            os.replace(tmp, lib)   # atomic: a concurrent build is harmless
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return libs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        _LOADED[name] = lib
    return lib
