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
* `qgemm_faithful_sr` — the stochastically rounded scan (the JAX
  package's SR faithful scan, `cpd_tpu/quant/quant_function.py:257-285`):
  the cast at site s of step k takes the bits of
  ``random_bits(fold_in(fold_in(key, k), s), (M, N))``.  On a CUDA
  tensor the tile kernel's SR arm, which draws them in the kernel from
  a (K, 5) table of site keys that a small kernel computes first
  (`site_keys` is its plain version), counted in
  ``qgemm_faithful_sr.launches``.
* `qgemm_faithful_stats` — either scan with `quant_health`'s counters
  over every cast (sat, underflow, nan, total = 5·K·M·N) as exact int64
  counts; the product is bitwise the scan's.  On a CUDA tensor the tile
  kernel's stats arm, counted in ``qgemm_faithful_stats.launches``.
* `generic_launcher` — the kernel the tile kernel replaced (one output
  per thread, the generic cast), kept as the yardstick that
  ``chip_smoke.py`` times the tile kernel against.  No path calls it.

Kernel and plain version are bitwise the same function: every float op
of the kernel is round-to-nearest without FMA contraction, as torch's
elementwise ops are.  A CUDA tensor never takes the plain scan: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import prng
from ..quant.numerics import _validate, cast_body, cast_body_sr

__all__ = ["qgemm_faithful", "qgemm_faithful_sr", "qgemm_faithful_stats",
           "qgemm_faithful_ref", "site_keys", "cast_constants",
           "cast_probe_patterns", "generic_launcher"]

SITES = 5                 # cast sites of a Kahan step
_INF_BITS = 0x7F800000
# the plain SR scan draws its bits for several steps at once, up to this
# many elements of one int64 threefry stream
_BITS_ELEMS = 1 << 24


def _shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qgemm expects (M,K)x(K,N); got {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")


def site_keys(key: tuple, k: int, device="cpu") -> torch.Tensor:
    """The SR scan's key table: ``fold_in(fold_in(key, j), site)`` for
    step j < k and site < 5, as a (k, 5, 2) int64 tensor of uint32
    words, one vectorised threefry2x32 per fold on ``device`` (the plain
    version of the SR arm's ``site_keys_kernel``)."""
    j = torch.arange(k, dtype=torch.int64, device=device)
    a0, a1 = prng.threefry2x32(int(key[0]), int(key[1]), 0, j)
    site = torch.arange(SITES, dtype=torch.int64, device=device)
    b0, b1 = prng.threefry2x32(a0[:, None], a1[:, None], 0, site[None, :])
    return torch.stack([b0, b1], -1)


def _sr_outputs(m: int, n: int) -> None:
    if m * n >= 1 << 32:
        raise ValueError(f"{m * n} outputs: the SR bits' 32-bit counter "
                         "would wrap")


def _tally(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[sat, underflow, nan] of one cast, int64, by bit pattern
    (`numerics.quant_health`)."""
    xb = x.reshape(-1).view(torch.int32) & 0x7FFFFFFF
    qb = q.reshape(-1).view(torch.int32) & 0x7FFFFFFF
    return torch.stack([(qb == _INF_BITS).sum(),
                        ((qb == 0) & (xb != 0) & (xb < _INF_BITS)).sum(),
                        (xb > _INF_BITS).sum()])


def qgemm_faithful_ref(a: torch.Tensor, b: torch.Tensor, exp_bits: int,
                       man_bits: int, key=None, stats: bool = False):
    """Plain version of K8 and of its arms: the ordered quantized Kahan
    scan over k, RTNE, or with ``key`` stochastically rounded (site s of
    step k on the bits of ``random_bits(fold_in(fold_in(key, k), s), (M,
    N))``).  With ``stats`` it returns ``(out, counts)``, counts the int64
    (4,) [sat, underflow, nan, total] over every cast."""
    _validate(exp_bits, man_bits)
    _shapes(a, b)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, kdim, n = a.shape[0], a.shape[1], b.shape[1]
    s = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    c = torch.zeros_like(s)
    counts = torch.zeros(3, dtype=torch.int64, device=a.device)
    keys = None
    if key is not None:
        _sr_outputs(m, n)
        keys = site_keys(key, kdim, a.device)
        flat = torch.arange(m * n, dtype=torch.int64, device=a.device)
    chunk = max(1, _BITS_ELEMS // max(SITES * m * n, 1))

    def q(t, bits):
        out = (cast_body(t, exp_bits, man_bits) if bits is None
               else cast_body_sr(t, exp_bits, man_bits, bits))
        if stats:
            counts.add_(_tally(t, out))
        return out

    for k0 in range(0, kdim, chunk):
        bits = None
        if keys is not None:
            kk = keys[k0:k0 + chunk]
            x0, x1 = prng.threefry2x32(kk[..., 0, None], kk[..., 1, None],
                                       0, flat)
            bits = x0 ^ x1                     # (steps, sites, m * n)
        for j in range(min(chunk, kdim - k0)):
            k = k0 + j

            def site(i):
                return None if bits is None else bits[j, i]

            tmp = q(a[:, k, None] * b[None, k, :], site(0))
            y = q(tmp - c, site(1))
            t = q(s + y, site(2))
            if k < kdim - 1 or stats:
                # the last step's compensation is read by nothing but the
                # counts
                c = q(q(t - s, site(3)) - y, site(4))
            s = t
    if not stats:
        return s
    total = torch.full((1,), SITES * kdim * m * n, dtype=torch.int64,
                       device=a.device)
    return s, torch.cat([counts, total])


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
        lib.qgemm_arm_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 3 + [CastBits] + [ctypes.c_uint32] * 2 \
            + [ctypes.c_void_p] * 3
        lib.qgemm_arm_launch.restype = ctypes.c_int
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


def _key(key) -> tuple:
    if key is None or len(key) != 2:
        raise ValueError(f"an SR key is a pair of uint32 words, got {key!r}")
    return int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF


def _arm(a, b, exp_bits, man_bits, key, counts) -> torch.Tensor:
    """One launch of the tile kernel's SR and/or stats arm on CUDA
    tensors: ``key`` (or None for RTNE) and ``counts`` (a zeroed int64
    (4,) tensor on the card, or None)."""
    m, n, k = a.shape[0], b.shape[1], a.shape[1]
    if key is not None:
        _sr_outputs(m, n)
    if counts is not None and k >= 1 << 27:
        raise ValueError(f"K = {k}: a thread's 32-bit counts could wrap")
    # the kernel fills the (k, 5) table of site keys first
    keys = (None if key is None else
            torch.empty((k, SITES, 2), dtype=torch.int32, device=a.device))
    key = (0, 0) if key is None else key
    f = cast_constants(exp_bits, man_bits)
    return _launch(a, b, 32, lambda lib, args, stream: lib.qgemm_arm_launch(
        *args, f, key[0], key[1], None if keys is None else keys.data_ptr(),
        None if counts is None else counts.data_ptr(), stream))


def qgemm_faithful_sr(a: torch.Tensor, b: torch.Tensor, exp_bits: int,
                      man_bits: int, key: tuple) -> torch.Tensor:
    """The stochastically rounded quantized Kahan GEMM (K8's SR arm) with
    the JAX package's key schedule: CPU tensors take
    `qgemm_faithful_ref`; CUDA tensors one launch of the SR arm, counted
    in ``qgemm_faithful_sr.launches``.  M·N < 2^32."""
    _checked(a, b, exp_bits, man_bits)
    key = _key(key)
    if a.device.type == "cpu":
        return qgemm_faithful_ref(a, b, exp_bits, man_bits, key=key)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = _arm(a, b, exp_bits, man_bits, key, None)
    qgemm_faithful_sr.launches += 1
    return out


qgemm_faithful_sr.launches = 0


def qgemm_faithful_stats(a: torch.Tensor, b: torch.Tensor, exp_bits: int,
                         man_bits: int, key=None) -> tuple:
    """``(out, counts)``: the RTNE scan (or with ``key`` the SR one) and
    the int64 (4,) [sat, underflow, nan, total] of its 5·K·M·N casts,
    exact (K8's stats arm; the product bitwise the arm without
    counting).  CPU tensors take `qgemm_faithful_ref`; CUDA tensors one
    launch, counted in ``qgemm_faithful_stats.launches``."""
    _checked(a, b, exp_bits, man_bits)
    key = None if key is None else _key(key)
    if a.device.type == "cpu":
        return qgemm_faithful_ref(a, b, exp_bits, man_bits, key=key,
                                  stats=True)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    counts = torch.zeros(4, dtype=torch.int64, device=a.device)
    out = _arm(a, b, exp_bits, man_bits, key, counts)
    qgemm_faithful_stats.launches += 1
    return out, counts


qgemm_faithful_stats.launches = 0


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
