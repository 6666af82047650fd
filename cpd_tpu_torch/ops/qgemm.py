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
  CUDA tensors launch the hand-written tile kernel in ``csrc/qgemm.cu``
  (built at first use, `ops.build`) or raise.  Launches are counted in
  ``qgemm_faithful.launches``.  The kernel takes the format as the
  constants of its cast, `cast_constants`.
* `generic_launcher` — the kernel the tile kernel replaced (one output
  per thread, the generic cast), kept as the yardstick that
  ``chip_smoke.py`` times the tile kernel against.  No path calls it.

Both are bitwise the same function: every float op of the kernel is
round-to-nearest without FMA contraction, as torch's elementwise ops
are.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.numerics import _validate, cast_body

__all__ = ["qgemm_faithful", "qgemm_faithful_ref", "cast_constants",
           "cast_probe_patterns", "generic_launcher"]


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


class CastBits(ctypes.Structure):
    """``exmy::CastBits`` of ``csrc/exmy.cuh``, field for field."""

    _fields_ = [("norm", ctypes.c_uint32), ("sat", ctypes.c_uint32),
                ("tiny", ctypes.c_uint32), ("kmul", ctypes.c_float),
                ("exp_bits", ctypes.c_int32), ("man_bits", ctypes.c_int32),
                ("fadd", ctypes.c_int32)]


def cast_constants(exp_bits: int, man_bits: int) -> CastBits:
    """The per-format constants of the kernel's cast through the fp32
    adder (``exmy::cast_fadd``) and of its zero steps, with bias =
    2^(eb-1) - 1 and shift = 23 - mb: |x| >= ``norm`` has a normal target,
    |x| >= ``sat`` saturates, |x| < ``tiny`` casts to a zero; ``kmul`` =
    1.5 * 2^shift scales cast_fadd's rounding constant, and ``fadd`` says
    where that cast is exact (eb <= 7, mb <= 21: no overflow of the
    constant, and room for the input in its binade); other formats take
    the reference cast."""
    _validate(exp_bits, man_bits)
    bias = (1 << (exp_bits - 1)) - 1
    shift = 23 - man_bits
    return CastBits(
        norm=(128 - bias) << 23, sat=(127 - bias + (1 << exp_bits) - 1) << 23,
        tiny=max(128 - bias + shift - 24, 1) << 23,
        kmul=1.5 * 2.0**shift, exp_bits=exp_bits, man_bits=man_bits,
        fadd=int(exp_bits <= 7 and man_bits <= 21))


def cast_probe_patterns(exp_bits: int, man_bits: int,
                        per_exponent: int = 128, seed: int = 0):
    """fp32 bit patterns (numpy uint32) that hold a cast of the format to
    its reference at every rounding boundary: ``per_exponent`` mantissas x
    both signs at each of the 256 exponent fields.  At each exponent the
    mantissas put the round bit at s - 1, where s = shift + p is the bit
    the format rounds at and p the low bits a subnormal target truncates
    first: the lsb (bit s) and the round bit each 0 or 1; the sticky bits
    none, all, only the lowest kept one (bit p), only the highest
    truncated one (bit p - 1), only bit 0, or all the truncated ones; the
    bits above s none or all.  Then 2^j - 1, 2^j and 2^j + 1 for every j,
    and the rest random from ``seed``.  Used by the card's cast probe
    (``chip_smoke.py`` phase 10a) and the CPU model tests."""
    import numpy as np

    f = cast_constants(exp_bits, man_bits)
    rng = np.random.default_rng([seed, exp_bits, man_bits])
    e = np.arange(256, dtype=np.int64)[:, None]
    p = np.where(e > 0, np.maximum((f.norm >> 23) - e, 0), 0)
    s = np.minimum(23 - man_bits + p, 24)
    lsb, rnd, st, hi = (x.reshape(1, -1) for x in np.meshgrid(
        np.arange(2), np.arange(2), np.arange(6), np.arange(2),
        indexing="ij"))
    one = np.int64(1)
    below = (one << np.maximum(s - 1, 0)) - 1
    sticky = np.select(
        [st == 1, (st == 2) & (p < s - 1), (st == 3) & (p >= 1),
         (st == 4) & (s >= 2), st == 5],
        [below, one << np.minimum(p, 62), one << np.maximum(p - 1, 0),
         np.ones_like(s), (one << np.minimum(p, 23)) - 1], 0) & below
    above = np.minimum(s + 1, 23)
    m = (np.where(s <= 22, lsb << np.minimum(s, 22), 0)
         | np.where(s >= 1, rnd << np.maximum(s - 1, 0), 0) | sticky
         | np.where(hi == 1, (0x7FFFFF >> above) << above, 0))
    j = np.arange(23, dtype=np.int64)
    fixed = np.concatenate([(one << j) + d for d in (-1, 0, 1)])
    m = np.concatenate([m, np.broadcast_to(fixed, (256, fixed.size))], 1)
    if m.shape[1] > per_exponent:
        raise ValueError(f"per_exponent must be at least {m.shape[1]}")
    m = np.concatenate([m, rng.integers(0, 1 << 23, (256, per_exponent
                                                     - m.shape[1]))], 1)
    bits = (e << 23) | (m & 0x7FFFFF)
    return np.concatenate([bits, bits | (one << 31)]).astype(
        np.uint32).ravel()


def _library():
    from .build import load_library

    lib = load_library("qgemm")
    if not getattr(lib, "_cpd_typed", False):
        lib.qgemm_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 3 + [CastBits, ctypes.c_void_p]
        lib.qgemm_launch.restype = ctypes.c_int
        lib.qgemm_generic_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.qgemm_generic_launch.restype = ctypes.c_int
        lib.qgemm_error_string.argtypes = [ctypes.c_int]
        lib.qgemm_error_string.restype = ctypes.c_char_p
        lib._cpd_typed = True
    return lib


def _launch(a: torch.Tensor, b: torch.Tensor, tile: int,
            launch) -> torch.Tensor:
    """Checks, then ``launch(lib, (a, b, out, m, n, k), stream)`` (device
    pointers as ints) of a kernel whose CTA covers ``tile`` x ``tile``
    outputs, for CUDA tensors."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2**31 or -(-m // tile) > 65535:
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
        rc = launch(lib, (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
                          k), torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm kernel launch failed: "
                           f"{lib.qgemm_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    return out


def _checked(a: torch.Tensor, b: torch.Tensor, exp_bits: int,
             man_bits: int) -> None:
    _validate(exp_bits, man_bits)
    _shapes(a, b)
    if a.device != b.device:
        raise ValueError(f"inputs on several devices: {a.device}, "
                         f"{b.device}")


def qgemm_faithful(a: torch.Tensor, b: torch.Tensor, exp_bits: int,
                   man_bits: int) -> torch.Tensor:
    """(M, K) @ (K, N) fp32 with the quantized Kahan eXmY accumulator
    (K8).  Any strides; the kernel reads contiguous copies.  CPU tensors
    take `qgemm_faithful_ref`; CUDA tensors launch the tile kernel,
    counted in ``qgemm_faithful.launches``."""
    _checked(a, b, exp_bits, man_bits)
    if a.device.type == "cpu":
        return qgemm_faithful_ref(a, b, exp_bits, man_bits)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    f = cast_constants(exp_bits, man_bits)
    out = _launch(a, b, 32, lambda lib, args, stream: lib.qgemm_launch(
        *args, f, stream))
    qgemm_faithful.launches += 1
    return out


qgemm_faithful.launches = 0


def generic_launcher():
    """The launch function of the kernel the tile kernel replaced
    (``qgemm_generic_launch``: a CTA per 16 x 16 outputs, one per thread,
    ``exmy::cast``), ``fn(a, b, exp_bits, man_bits) -> out`` on CUDA
    tensors.  No path calls it: it is the yardstick ``chip_smoke.py``
    times the tile kernel against, and a second oracle there.  Its
    launches are not counted."""

    def launch(a, b, exp_bits, man_bits):
        _checked(a, b, exp_bits, man_bits)
        if a.device.type != "cuda":
            raise ValueError(f"the generic kernel runs on CUDA tensors; "
                             f"got {a.device}")
        return _launch(a, b, 16, lambda lib, args, stream:
                       lib.qgemm_generic_launch(*args, exp_bits, man_bits,
                                                stream))

    return launch
