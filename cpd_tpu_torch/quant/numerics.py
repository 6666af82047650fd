"""The eXmY custom-precision cast and its wire codec, in PyTorch.

Port of `cpd_tpu/quant/numerics.py` (the reference for every rule below;
tests/test_torch_numerics.py holds this module to it bitwise).  Only the
pieces the ported slices need are here: the RTNE and the stochastically
rounded cast (`cast_to_format`, `cast_to_format_sr_at` run them as CUDA
kernels on the card), the packed eXmY code words the KV pages and the
ring wire carry, and the block-scaled codec.

Semantics, in short (the JAX module's docstring has the full account):

* FP32 in; target format ``exp_bits`` (1..8) / ``man_bits`` (0..23).
* Inf / NaN / ±0 pass through; FP32 subnormal inputs flush to +0.0.
* Exponent overflow is checked BEFORE rounding and saturates to ±Inf;
  a value that only rounds past the max carries into ``2^(emax+1)``.
* Round-to-nearest-even at bit ``23 - man_bits`` (or, in the SR cast,
  add the low ``23 - man_bits`` random bits and truncate); subnormal
  targets take a truncating pre-shift, then the same rounding.

Bit arithmetic runs in int64 on the fp32 bit pattern (``view(int32)``
masked to 32 bits), so no shift is arithmetic on a sign bit and no
product wraps.  Powers of two are assembled from their bits (`_pow2`),
never taken from ``exp2``, so the CPU and the card give the same bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cast_body", "cast_body_sr", "cast_to_format",
           "cast_to_format_sr", "cast_to_format_sr_at", "HEALTH_FIELDS",
           "quant_health", "cast_to_format_stats", "max_finite",
           "wire_bytes",
           "kv_page_bytes", "pack_code", "pack_exmy", "unpack_code",
           "unpack_exmy", "format_max_exponent", "sidecar_bytes",
           "block_shifts", "cast_body_blocked", "pack_exmy_blocked",
           "unpack_exmy_blocked", "wire_bytes_blocked"]

_U32 = 0xFFFFFFFF


def _validate(exp_bits: int, man_bits: int) -> None:
    if not (1 <= exp_bits <= 8):
        raise ValueError(f"exp_bits must be in [1, 8], got {exp_bits}")
    if not (0 <= man_bits <= 23):
        raise ValueError(f"man_bits must be in [0, 23], got {man_bits}")


def _validate_wire(exp_bits: int, man_bits: int) -> None:
    _validate(exp_bits, man_bits)
    if man_bits < 2 and not (exp_bits == 8 and man_bits == 23):
        raise ValueError(
            f"pack_exmy needs man_bits >= 2 (got ({exp_bits}, {man_bits})): "
            "the all-ones exponent block must hold the Inf/carry/NaN "
            "special codes; ship such formats as raw fp32 instead")


def max_finite(exp_bits: int, man_bits: int) -> float:
    """Largest normal value of the format (the all-ones exponent field
    is reserved, as in the reference cast)."""
    _validate(exp_bits, man_bits)
    bias = (1 << (exp_bits - 1)) - 1
    e_max = ((1 << exp_bits) - 2) - bias
    return (2.0 - 2.0 ** (-man_bits)) * (2.0 ** e_max)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> its bit pattern as int64 in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & _U32


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> the fp32 with that bit pattern."""
    b = torch.where(b >= (1 << 31), b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def _rtne(man: torch.Tensor, shift: int) -> torch.Tensor:
    """Round-to-nearest-even of an integer significand at bit `shift`."""
    if shift <= 0:
        return man
    half = 1 << (shift - 1)
    round_bit = (man & half) != 0
    sticky = (man & (half - 1)) != 0
    lsb = (man & (1 << shift)) != 0
    man = torch.where(round_bit & (sticky | lsb), man + half, man)
    return man & ~((1 << shift) - 1)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact fp32 2^e for integer e in [-126, 127], by bit assembly."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _sr(man: torch.Tensor, shift: int, rbits: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of an integer significand at bit `shift`: add
    the low `shift` bits of ``rbits`` and truncate (the identity when
    ``shift <= 0``)."""
    if shift <= 0:
        return man
    r = rbits.to(torch.int64) & ((1 << shift) - 1)
    return (man + r) & ~((1 << shift) - 1)


def _cast_core(x: torch.Tensor, exp_bits: int, man_bits: int,
               round_fn) -> torch.Tensor:
    """The cast without its rounding step: ``round_fn(man)`` rounds an
    integer significand at bit ``23 - man_bits``.  Both the normal and
    the subnormal-target significand go through the same ``round_fn``."""
    _validate(exp_bits, man_bits)
    x = x.to(torch.float32)
    bits = _bits(x)
    exp_f = (bits >> 23) & 0xFF
    man_f = bits & 0x007FFFFF
    negative = (bits >> 31) != 0

    passthrough = (exp_f == 0xFF) | ((exp_f == 0) & (man_f == 0))
    flush_to_zero = (exp_f == 0) & (man_f != 0)

    bias = (1 << (exp_bits - 1)) - 1
    man24 = man_f | (1 << 23)
    new_e = exp_f - 127 + bias
    overflow = new_e >= ((1 << exp_bits) - 1)

    man_norm = round_fn(man24)
    e_norm = exp_f - 127
    # subnormal targets: truncating pre-shift, THEN round
    man_sub = round_fn(man24 >> torch.clamp(1 - new_e, 0, 24))

    is_sub = new_e <= 0
    man_out = torch.where(is_sub, man_sub, man_norm)
    e_out = torch.where(is_sub, 1 - bias, e_norm)

    # man * 2^(e-23) as two exact power-of-two factors, so the subnormal
    # tail never rounds
    e = e_out - 23
    a = torch.clamp(e, -126, 127)
    mag = man_out.to(torch.float32) * _pow2(a) * _pow2(e - a)
    val = torch.where(negative, -mag, mag)
    inf = torch.where(negative, -torch.inf, torch.inf)
    val = torch.where(overflow, inf, val)
    val = torch.where(flush_to_zero, 0.0, val)
    return torch.where(passthrough, x, val)


def cast_body(x: torch.Tensor, exp_bits: int, man_bits: int) -> torch.Tensor:
    """RTNE cast of fp32 ``x`` into the (exp_bits, man_bits) value set."""
    shift = 23 - man_bits
    return _cast_core(x, exp_bits, man_bits, lambda m: _rtne(m, shift))


def cast_body_sr(x: torch.Tensor, exp_bits: int, man_bits: int,
                 rbits: torch.Tensor) -> torch.Tensor:
    """Stochastically rounded cast: ``rbits`` (an integer tensor of
    uint32 values or their int32 patterns, ``x``'s size) decides each
    element's round direction by its low ``23 - man_bits`` bits.  Every
    other rule is the RTNE cast's."""
    shift = 23 - man_bits
    if rbits.numel() == x.numel():
        rbits = rbits.reshape(x.shape)
    else:
        rbits = rbits.expand(x.shape)
    return _cast_core(x, exp_bits, man_bits, lambda m: _sr(m, shift, rbits))


def cast_to_format(x: torch.Tensor, exp_bits: int,
                   man_bits: int) -> torch.Tensor:
    """The public RTNE cast: on a CUDA tensor one launch of the
    hand-written kernel (K1, `ops.quantize.quantize_cast`), on a CPU
    tensor `cast_body`.  Bitwise the same function either way."""
    from ..ops.quantize import quantize_cast   # ops imports this module

    return quantize_cast(x, exp_bits, man_bits)


def cast_to_format_sr(x: torch.Tensor, exp_bits: int, man_bits: int,
                      key: tuple) -> torch.Tensor:
    """Stochastically rounded cast with the bits of
    ``jax.random.bits(key, x.shape)`` (`prng.random_bits`); on a CUDA
    tensor the bits are the flat arm of the `sr_bits` kernel and the cast
    is K2 (`ops.quantize.quantize_cast_sr`), on a CPU one their plain
    versions."""
    from ..ops.quantize import quantize_cast_sr, sr_bits

    return quantize_cast_sr(x, exp_bits, man_bits,
                            sr_bits(key, x, flat=True))


def cast_to_format_sr_at(x: torch.Tensor, exp_bits: int, man_bits: int,
                         key: tuple, offsets: torch.Tensor) -> torch.Tensor:
    """Stochastically rounded cast with offset-indexed bits
    (`prng.sr_bits_at(key, offsets)`, ``offsets`` of x's size, torch ops
    on ``x``'s device: the `sr_bits` kernel draws runs of contiguous
    offsets only); the cast is K2 on a CUDA tensor, `cast_body_sr` on a
    CPU one."""
    from ..ops.quantize import quantize_cast_sr
    from .prng import sr_bits_at, to_int32_bits

    bits = sr_bits_at(key, offsets.to(x.device).reshape(x.shape))
    return quantize_cast_sr(x, exp_bits, man_bits, to_int32_bits(bits))


# --------------------------------------------------------------------------
# Packed eXmY code words: [ man (m) | exp (e) | sign (1) ], little-endian
# in wire_bytes(e, m) bytes.  The all-ones exponent field holds the
# specials: man 0 -> ±Inf, man 1 -> ±2^(emax+1) (the carry value),
# man 2 -> NaN.  (8, 23) is the plain fp32 byte split.
# --------------------------------------------------------------------------


# -- numeric-health telemetry (`cpd_tpu/quant/numerics.py:316-355`) -----
# One cast's (input, output) pair, three failure signatures: ``sat`` — the
# output is ±Inf (saturation, or an Inf passed through); ``underflow`` — a
# non-zero finite input came out ±0 (the fp32-subnormal flush, or a
# subnormal target rounding its whole significand away); ``nan`` — NaN
# inputs.  ``total`` is the element count.  Pure observation: the cast's
# bits never depend on it.  The counters are float32 scalars (exact below
# 2^24), summable over leaves and ranks.

HEALTH_FIELDS = ("sat", "underflow", "nan", "total")

_MAG = 0x7FFFFFFF
_INF_BITS = 0x7F800000


def quant_health(x: torch.Tensor, q: torch.Tensor) -> dict:
    """{sat, underflow, nan, total} float32 scalars for one cast's input
    ``x`` and output ``q``.  Zero-ness, Inf and NaN are read off the BIT
    PATTERN (``& 0x7FFFFFFF``), never by a float compare, as the JAX
    function decides them (XLA:CPU compares under DAZ, where a subnormal
    == 0.0).  Each count is an integer sum taken to float32: equal to the
    JAX package's float32 sum of ones below 2^24 elements."""
    xb = x.to(torch.float32).reshape(-1).view(torch.int32) & _MAG
    qb = q.to(torch.float32).reshape(-1).view(torch.int32) & _MAG
    f32 = torch.float32
    return {
        "sat": (qb == _INF_BITS).sum().to(f32),
        "underflow": ((qb == 0) & (xb != 0) & (xb < _INF_BITS)).sum().to(
            f32),
        "nan": (xb > _INF_BITS).sum().to(f32),
        "total": torch.full((), float(x.numel()), dtype=f32,
                            device=x.device),
    }


def cast_to_format_stats(x: torch.Tensor, exp_bits: int,
                         man_bits: int) -> tuple:
    """`cast_to_format` plus its health counters: ``(q, health)``, ``q``
    bitwise the plain cast (K1 on a CUDA tensor, `cast_body` on a CPU
    one) and ``health`` = `quant_health(x, q)`."""
    q = cast_to_format(x, exp_bits, man_bits)
    return q, quant_health(x, q)


def wire_bytes(exp_bits: int, man_bits: int) -> int:
    """Bytes per element of the packed eXmY wire format."""
    _validate(exp_bits, man_bits)
    return (1 + exp_bits + man_bits + 7) // 8


def kv_page_bytes(exp_bits: int, man_bits: int, page_size: int,
                  n_kv_heads: int, head_dim: int,
                  block_size=None) -> int:
    """Bytes of ONE layer's K+V page in the packed codec (the blocked
    row's shift sidecar included when ``block_size`` is given)."""
    if page_size < 1 or n_kv_heads < 1 or head_dim < 1:
        raise ValueError(
            f"page_size/n_kv_heads/head_dim must be >= 1, got "
            f"({page_size}, {n_kv_heads}, {head_dim})")
    _validate_wire(exp_bits, man_bits)
    n = n_kv_heads * head_dim
    row = n * wire_bytes(exp_bits, man_bits)
    if block_size is not None:
        if exp_bits == 8 and man_bits == 23:
            raise ValueError("block_size at (8, 23): the fp32 byte split "
                             "has nothing to scale")
        row += sidecar_bytes(n, block_size)
    return 2 * page_size * row


def _split_bytes(code: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """int64 code words -> little-endian uint8, one trailing axis."""
    return torch.stack([((code >> (8 * k)) & 0xFF).to(torch.uint8)
                        for k in range(n_bytes)], dim=-1)


def _join_bytes(packed: torch.Tensor) -> torch.Tensor:
    """Little-endian uint8 (..., B) -> int64 code words (...)."""
    code = torch.zeros(packed.shape[:-1], dtype=torch.int64,
                       device=packed.device)
    for k in range(packed.shape[-1]):
        code = code | (packed[..., k].to(torch.int64) << (8 * k))
    return code


def pack_code(x: torch.Tensor, exp_bits: int, man_bits: int) -> torch.Tensor:
    """fp32 values in the (exp_bits, man_bits) value set -> int64 code
    words in [0, 2^32)."""
    _validate_wire(exp_bits, man_bits)
    bits = _bits(x.to(torch.float32))
    if exp_bits == 8 and man_bits == 23:
        return bits

    sign = (bits >> 31) & 1
    exp_f = (bits >> 23) & 0xFF
    man_f = bits & 0x007FFFFF
    bias = (1 << (exp_bits - 1)) - 1
    ones = (1 << exp_bits) - 1

    is_nan = (exp_f == 0xFF) & (man_f != 0)
    is_inf = (exp_f == 0xFF) & (man_f == 0)
    normal = exp_f > 0
    man24 = torch.where(normal, man_f | (1 << 23), man_f)
    f = torch.where(normal, exp_f - 127, -126) + bias
    is_sub = (f <= 0) | (exp_f == 0)
    is_carry = (~is_sub) & (exp_f != 0xFF) & (f >= ones)

    shift = torch.clamp(torch.clamp(1 - f, min=0) + (23 - man_bits), 0, 31)
    man_sub = man24 >> shift
    man_norm = man_f >> (23 - man_bits)

    exp_field = torch.where(is_sub, 0, torch.clamp(f, 0, ones))
    man_field = torch.where(is_sub, man_sub, man_norm)
    top_sign = sign << (exp_bits + man_bits)
    code = top_sign | (exp_field << man_bits) | man_field
    top = ones << man_bits
    code = torch.where(is_carry, top_sign | top | 1, code)
    code = torch.where(is_inf, top_sign | top, code)
    return torch.where(is_nan, torch.full_like(code, top | 2), code)


def pack_exmy(x: torch.Tensor, exp_bits: int, man_bits: int) -> torch.Tensor:
    """Pack fp32 values in the format's value set into little-endian
    uint8 code words of shape ``x.shape + (wire_bytes(),)``."""
    return _split_bytes(pack_code(x, exp_bits, man_bits),
                        wire_bytes(exp_bits, man_bits))


def unpack_code(code: torch.Tensor, exp_bits: int,
                man_bits: int) -> torch.Tensor:
    """int64 code words -> the exact fp32 bit patterns the cast made."""
    _validate_wire(exp_bits, man_bits)
    if exp_bits == 8 and man_bits == 23:
        return _from_bits(code)

    bias = (1 << (exp_bits - 1)) - 1
    ones = (1 << exp_bits) - 1
    sign = ((code >> (exp_bits + man_bits)) & 1) != 0
    exp_field = (code >> man_bits) & ones
    man_field = code & ((1 << man_bits) - 1)

    is_special = exp_field == ones
    is_sub = exp_field == 0
    mantissa = torch.where(is_sub, man_field, man_field | (1 << man_bits))
    e = torch.where(is_sub, 1, exp_field) - bias - man_bits
    # the carry special: 1 * 2^(e_max + 1), with e_max + 1 = ones - bias
    is_carry = is_special & (man_field == 1)
    mantissa = torch.where(is_carry, 1, mantissa)
    e = torch.where(is_carry, ones - bias, e)
    a = torch.clamp(e, -126, 127)
    b = torch.clamp(e - a, -126, 127)
    mag = mantissa.to(torch.float32) * _pow2(a) * _pow2(b)
    mag = torch.where(is_special & (man_field == 0), torch.inf, mag)
    val = torch.where(sign, -mag, mag)
    return torch.where(is_special & (man_field >= 2), torch.nan, val)


def unpack_exmy(packed: torch.Tensor, exp_bits: int,
                man_bits: int) -> torch.Tensor:
    """Inverse of `pack_exmy`: uint8 ``(..., wire_bytes())`` -> fp32."""
    n_bytes = wire_bytes(exp_bits, man_bits)
    if packed.shape[-1] != n_bytes:
        raise ValueError(f"trailing axis {packed.shape[-1]} != "
                         f"wire_bytes({exp_bits}, {man_bits}) = {n_bytes}")
    return unpack_code(_join_bytes(packed), exp_bits, man_bits)


# --------------------------------------------------------------------------
# Block-scaled codec: one power-of-two shift per block of `block_size`
# consecutive elements along the last axis (short tail block included),
# chosen so the block's max sits at the format's top exponent.  The wire
# is [ n * wire_bytes code bytes | one sidecar byte (k + 128) per block ].
# Everything below the fp32 normal floor canonicalizes to +0.0.
# --------------------------------------------------------------------------


def format_max_exponent(exp_bits: int) -> int:
    """Exponent of `max_finite(exp_bits, ·)`: (2^e - 2) - bias."""
    _validate(exp_bits, 0)
    return ((1 << exp_bits) - 2) - ((1 << (exp_bits - 1)) - 1)


def _scale_pow2(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """x * 2^e for integer e in [-252, 253], as two exact factors."""
    a = torch.clamp(e, -126, 127)
    return (x * _pow2(a)) * _pow2(torch.clamp(e - a, -126, 126))


def sidecar_bytes(n: int, block_size: int) -> int:
    """Sidecar bytes for n elements at one shift byte per block."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return -(-n // block_size) if n else 0


def wire_bytes_blocked(exp_bits: int, man_bits: int, n: int,
                       block_size: int) -> int:
    """Bytes of one block-scaled payload of n elements: the code words
    plus the sidecar lane (`pack_exmy_blocked`'s output size)."""
    _validate_wire(exp_bits, man_bits)
    return n * wire_bytes(exp_bits, man_bits) + sidecar_bytes(n, block_size)


def _flush_low(x: torch.Tensor) -> torch.Tensor:
    """Every pattern with a zero exponent field (±0, fp32 subnormals)
    -> +0.0."""
    low = ((_bits(x) >> 23) & 0xFF) == 0
    return torch.where(low, 0.0, x)


def block_shifts(x: torch.Tensor, exp_bits: int, man_bits: int,
                 block_size: int) -> torch.Tensor:
    """Per-block shift exponents k_b (int64), blocks of `block_size`
    along the last axis: shape ``x.shape[:-1] + (ceil(n / block_size),)``."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    x = _flush_low(x.to(torch.float32))
    n = x.shape[-1]
    nb = sidecar_bytes(n, block_size)
    mag = torch.where(torch.isfinite(x), x.abs(), 0.0)
    pad = nb * block_size - n
    if pad:
        mag = F.pad(mag, (0, pad))
    m_b = mag.reshape(x.shape[:-1] + (nb, block_size)).amax(dim=-1)
    _, e = torch.frexp(m_b)       # m = f * 2^e, f in [0.5, 1)
    emax = format_max_exponent(exp_bits)
    k = torch.where(m_b > 0, e.to(torch.int64) - 1 - emax, 0)
    return torch.clamp(k, -128, 127)


def _per_element_shifts(shifts: torch.Tensor, n: int,
                        block_size: int) -> torch.Tensor:
    """Broadcast (..., nb) block shifts to (..., n) element shifts."""
    return shifts.repeat_interleave(block_size, dim=-1)[..., :n]


def _unscale_flush(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q * 2^k, results that would be fp32-subnormal flushed to +0.0 —
    decided from exponent arithmetic, not from the product's bits."""
    _, e = torch.frexp(q)
    flush = (torch.isfinite(q) & (q != 0)
             & (e.to(torch.int64) + k <= -126))
    return _flush_low(torch.where(flush, 0.0, _scale_pow2(q, k)))


def _block_quantize(x: torch.Tensor, exp_bits: int, man_bits: int,
                    block_size: int, rbits=None) -> tuple:
    """Shift-scale-cast-clamp core shared by the blocked cast and the
    blocked packer: ``(q_scaled, shifts, k_elem)``.  The cast rounds to
    nearest even, or stochastically with ``rbits`` (`cast_body_sr`)."""
    _validate(exp_bits, man_bits)
    x = _flush_low(x.to(torch.float32))
    shifts = block_shifts(x, exp_bits, man_bits, block_size)
    k = _per_element_shifts(shifts, x.shape[-1], block_size)
    _, ex = torch.frexp(x)
    tiny = (torch.isfinite(x) & (x != 0)
            & (ex.to(torch.int64) - 1 - k <= -127))
    x = torch.where(tiny, 0.0, x)
    y = _scale_pow2(x, -k)
    q = (cast_body(y, exp_bits, man_bits) if rbits is None
         else cast_body_sr(y, exp_bits, man_bits, rbits))
    mf = max_finite(exp_bits, man_bits)
    carry = torch.isfinite(y) & (q.abs() > mf)
    q = torch.where(carry, torch.where(q > 0, mf, -mf), q)
    return q, shifts, k


def cast_body_blocked(x: torch.Tensor, exp_bits: int, man_bits: int,
                      block_size: int, rbits=None) -> torch.Tensor:
    """Block-scaled cast (blocks along the last axis): RTNE, or SR with
    the round bits ``rbits`` (x's size), the carry clamped to
    ±max_finite either way."""
    q, _, k = _block_quantize(x, exp_bits, man_bits, block_size, rbits)
    return _unscale_flush(q, k)


def pack_exmy_blocked(x: torch.Tensor, exp_bits: int, man_bits: int,
                      block_size: int) -> torch.Tensor:
    """Quantize and pack into the block-scaled wire: ``n * wire_bytes``
    code bytes, then ``ceil(n / block_size)`` sidecar bytes (k + 128)."""
    _validate_wire(exp_bits, man_bits)
    n = x.shape[-1]
    q, shifts, _ = _block_quantize(x, exp_bits, man_bits, block_size)
    codes = pack_exmy(q, exp_bits, man_bits)
    codes = codes.reshape(x.shape[:-1] + (n * codes.shape[-1],))
    sidecar = (shifts + 128).to(torch.uint8)
    return torch.cat([codes, sidecar], dim=-1)


def unpack_exmy_blocked(packed: torch.Tensor, exp_bits: int, man_bits: int,
                        n: int, block_size: int) -> torch.Tensor:
    """Inverse of `pack_exmy_blocked`: the blocked cast's output bits."""
    _validate_wire(exp_bits, man_bits)
    wb = wire_bytes(exp_bits, man_bits)
    nb = sidecar_bytes(n, block_size)
    if packed.shape[-1] != n * wb + nb:
        raise ValueError(
            f"trailing axis {packed.shape[-1]} != n * wire_bytes + "
            f"sidecar = {n * wb + nb} (n={n}, block={block_size})")
    codes = packed[..., :n * wb].reshape(packed.shape[:-1] + (n, wb))
    shifts = packed[..., n * wb:].to(torch.int64) - 128
    q = unpack_exmy(codes, exp_bits, man_bits)
    k = _per_element_shifts(shifts, n, block_size)
    return _unscale_flush(q, k)
