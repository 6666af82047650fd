"""The quantized-Kahan-accumulator GEMM (K8) and its plain version.

Port of `cpd_tpu/ops/qgemm.py` (`qgemm_pallas`, body `_qgemm_kernel`):
(M, K) @ (K, N) with an eXmY accumulator.  For every output element and
k = 0..K-1 in ascending order, with s = c = 0 to start:

    tmp = q(a[m, k] * b[k, n])
    y   = q(tmp - c)
    t   = q(s + y)
    c   = q(q(t - s) - y)
    s   = t

q being the RTNE cast `cast_body`.  This is the faithful mode of
`quant.quant_function.qgemm`, the reference CUDA `tvm_gemm`'s numerics.

* `qgemm_faithful_ref` — the same scan in torch ops: one rank-1 product
  and five `cast_body` calls per k.  Slow by design (~150 eager kernels
  per k step); it runs for CPU tensors and in the kernel's checks.
* `qgemm_faithful` — the wrapper.  CPU tensors take the plain version;
  CUDA tensors launch the hand-written kernel in ``csrc/qgemm.cu`` (built
  at first use, `ops.build`) or raise.  Launches are counted in
  ``qgemm_faithful.launches``.

Both are bitwise the same function: every float op of the kernel is
round-to-nearest without FMA contraction, as torch's elementwise ops
are.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.numerics import _validate, cast_body

__all__ = ["qgemm_faithful", "qgemm_faithful_ref"]


def _shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qgemm expects (M,K)x(K,N); got {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")


def qgemm_faithful_ref(a: torch.Tensor, b: torch.Tensor, exp_bits: int,
                       man_bits: int) -> torch.Tensor:
    """Plain version of K8: the ordered quantized Kahan scan over k."""
    _validate(exp_bits, man_bits)
    _shapes(a, b)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, n = a.shape[0], b.shape[1]
    s = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    c = torch.zeros_like(s)

    def q(t):
        return cast_body(t, exp_bits, man_bits)

    for k in range(a.shape[1]):
        tmp = q(a[:, k, None] * b[None, k, :])
        y = q(tmp - c)
        t = q(s + y)
        c = q(q(t - s) - y)
        s = t
    return s


def _library():
    from .build import load_library

    lib = load_library("qgemm")
    if not getattr(lib, "_cpd_typed", False):
        lib.qgemm_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.qgemm_launch.restype = ctypes.c_int
        lib.qgemm_error_string.argtypes = [ctypes.c_int]
        lib.qgemm_error_string.restype = ctypes.c_char_p
        lib._cpd_typed = True
    return lib


def qgemm_faithful(a: torch.Tensor, b: torch.Tensor, exp_bits: int,
                   man_bits: int) -> torch.Tensor:
    """(M, K) @ (K, N) fp32 with the quantized Kahan eXmY accumulator
    (K8).  Any strides; the kernel reads contiguous copies.  CPU tensors
    take `qgemm_faithful_ref`; CUDA tensors launch the kernel, counted in
    ``qgemm_faithful.launches``."""
    _validate(exp_bits, man_bits)
    _shapes(a, b)
    if a.device != b.device:
        raise ValueError(f"inputs on several devices: {a.device}, "
                         f"{b.device}")
    if a.device.type == "cpu":
        return qgemm_faithful_ref(a, b, exp_bits, man_bits)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2**31 or -(-m // 16) > 65535:
        raise ValueError(f"qgemm shape ({m}, {k}) x ({k}, {n}) is too large "
                         "for the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    a = a.contiguous()
    b = b.contiguous()
    lib = _library()
    with torch.cuda.device(a.device):
        rc = lib.qgemm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                              n, k, exp_bits, man_bits,
                              torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm kernel launch failed: "
                           f"{lib.qgemm_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    qgemm_faithful.launches += 1
    return out


qgemm_faithful.launches = 0
