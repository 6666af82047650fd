"""threefry2x32 keys and bits, bitwise those of `jax.random` (jax 0.9.0,
``jax_threefry_partitionable=True``).

The JAX package draws every stochastic-rounding bit from `jax.random`;
this module is the port's own counterpart of the part it uses.  It has
no JAX module of its own to mirror.  With ``TF(k, (x0, x1))`` the
20-round threefry2x32 (rotations 13,15,26,6 / 17,29,16,24, key schedule
``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``):

* ``PRNGKey(s)`` = ``(0, s & 0xFFFFFFFF)`` (64-bit types off, the JAX
  package's setting);
* ``fold_in(k, d)`` = ``TF(k, (0, d))``;
* ``split(k, n)[i]`` = ``TF(k, (0, i))``;
* ``random_bits(k, shape)[i]`` = ``x0 ^ x1`` of ``TF(k, (0, i))``, i the
  flat index (`jax.random.bits(k, shape, uint32)`);
* ``sr_bits_at(k, o)`` = ``random_bits(fold_in(k, o), ())``: each
  element's bits depend on (key, offset) only, never on the array that
  holds it (`cpd_tpu.quant.numerics.sr_bits_at`).

Keys are pairs of Python ints ``(k0, k1)``; only per-element bits are
tensors.  Bits come back as int64 tensors holding the uint32 values.
The arithmetic runs in int64 on non-negative values, masked to 32 bits
after every add and shift, so nothing wraps or shifts arithmetically;
the same function serves Python ints (the keys) and tensors (the bits).
On the card, the reduce draws its bits with the hand-written `sr_bits`
kernel (`ops.quantize`), which these functions are the plain version of.
"""

from __future__ import annotations

import torch

__all__ = ["threefry2x32", "PRNGKey", "fold_in", "split", "random_bits",
           "sr_bits_at", "site_key", "to_int32_bits"]

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1) -> tuple:
    """``TF((k0, k1), (x0, x1))``: Python ints or int64 tensors holding
    uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def PRNGKey(seed: int) -> tuple:
    """`jax.random.PRNGKey(seed)` with 64-bit types off: the seed is
    taken mod 2^32."""
    return (0, int(seed) & _M)


def fold_in(key: tuple, data: int) -> tuple:
    """`jax.random.fold_in(key, data)`, data taken as uint32."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M)


def split(key: tuple, num: int = 2) -> list:
    """`jax.random.split(key, num)` as a list of keys."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def site_key(key: tuple, step: int, site: int) -> tuple:
    """``fold_in(fold_in(key, step), site)``: the key of one cast site of
    one scan step or ring hop (`cpd_tpu.parallel.reduction._make_q`)."""
    return fold_in(fold_in(key, step), site)


def random_bits(key: tuple, shape, device="cpu") -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` as an int64 tensor."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    if n >= 1 << 32:
        raise ValueError(f"{n} elements: the 32-bit counter would wrap")
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key[0], key[1], 0, i)
    return (x0 ^ x1).reshape(shape)


def sr_bits_at(key: tuple, offsets: torch.Tensor) -> torch.Tensor:
    """The offset-indexed SR bitstream: ``x0 ^ x1`` of
    ``TF(TF(key, (0, o)), (0, 0))`` per offset ``o`` (taken mod 2^32),
    as an int64 tensor of ``offsets``' shape."""
    o = offsets.to(torch.int64) & _M
    a, b = threefry2x32(key[0], key[1], 0, o)
    x0, x1 = threefry2x32(a, b, 0, 0)
    return x0 ^ x1


def to_int32_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 values (any integer tensor) -> int32 tensors with the same
    32-bit patterns: the operand type of the SR kernels."""
    if bits.dtype == torch.int32:
        return bits
    b = bits.to(torch.int64) & _M
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)
