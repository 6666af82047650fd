"""The eXmY quantize kernels of the gradient reduce, and their plain versions.

Port of the six TPU kernels of `cpd_tpu/ops/quantize.py` that the
data-parallel training path runs (per-tensor, clean transport):

* `quantize_cast` (K1, `quantize_pallas`) — ``cast_body(x)``, the APS
  pre-quantize of every gradient leaf;
* `quantize_cast_sr` (K2, `quantize_pallas_sr`) — ``cast_body_sr(x, r)``,
  the stochastically rounded APS pre-quantize and the SR ring's hop 0 on
  an unpacked wire;
* `quantize_add` (K3, `quantize_add_pallas`) — ``cast_body(x + y)``, one
  step of the faithful ordered scan, a Kahan cast site, and the ring hop
  on an unpacked wire;
* `quantize_add_sr` (K4, `quantize_add_pallas_bits`) —
  ``cast_body_sr(x + y, r)``, the same sites with stochastic rounding;
* `quantize_pack` (K6, `quantize_pack_pallas`) — the ring's hop 0: cast
  (RTNE, or SR with ``rbits``: `quantize_pack_sr`) the local chunk and
  pack it into the ``(n, wb)`` wire (+ its digest);
* `hop_pack` (K5, `hop_pack_pallas`) — every later hop: unpack the
  received wire, add the local chunk, cast (SR with ``rbits``:
  `hop_pack_sr`), re-pack (+ the digests of both wires);
* the blocked arm of K6/K5 (``block_size`` of `quantize_pack` and
  `hop_pack`) — the same hops over the
  block-scaled wire: one power-of-two shift per block of ``block_size``
  elements, the cast clamped to ±max_finite, the sidecar of shift bytes
  after the code bytes, the digests over both lanes;
* `digest_rows` (K7, `digest_rows_pallas`) — the Fletcher digest of each
  row of a (W, B) uint8 buffer: the verified ring's all-gather check.

and of one helper that is no TPU kernel (JAX computes it in XLA):
`sr_bits`, the offset-indexed SR round bits ``prng.sr_bits_at(key, o)``
that K2/K4/K5/K6 take as their operand.  The SR kernels take the bits as
int32 tensors holding the uint32 patterns (`prng.to_int32_bits`).

Each wrapper takes the plain PyTorch version (``*_ref``, the same
function in torch ops) for CPU tensors and launches its hand-written
kernel in ``csrc/quantize.cu`` (built at first use, `ops.build`) for CUDA
tensors, or raises.  There is no fallback from the card to the plain
version.  K6 and K5 launch the streaming kernels (``run_wire_kernel``,
``run_blocked_kernel``: 16-byte accesses, the digests folded inside the
one launch); `core_wire_launcher` reaches the kernels they replaced,
which no path calls, as the yardstick ``chip_smoke.py`` times them
against.  K7 launches ``run_rows_kernel`` (one streaming launch over every
row, int64 digests written by the kernel); `core_digest_launcher` reaches
the two-launch kernel it replaced.  Each wrapper counts its launches in
``<wrapper>.launches``; the SR arms of K6 and K5 count theirs in
``quantize_pack_sr.launches`` and ``hop_pack_sr.launches`` only,
whichever name the caller used, and the blocked arms in the counters
``quantize_pack_blocked[_sr].launches`` and
``hop_pack_blocked[_sr].launches``.

The blocked kernel takes the JAX kernel's block sizes only: a multiple
of 128 that divides 65536 (the ring's default, 128, qualifies).  Other
sizes raise here, as `_wire_call` raises; the ring casts them with the
plain torch ops (`parallel/ring.py`).

Digests come back as int64 scalars holding the JAX package's uint32
values, as everywhere in the port.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from ..parallel.integrity import row_digests, wire_digest
from ..quant.numerics import (_validate, _validate_wire, cast_body,
                              cast_body_blocked, cast_body_sr, pack_exmy,
                              pack_exmy_blocked, sidecar_bytes, unpack_exmy,
                              unpack_exmy_blocked, wire_bytes,
                              wire_bytes_blocked)
from ..quant.prng import random_bits, sr_bits_at, to_int32_bits

__all__ = ["quantize_cast", "quantize_cast_sr", "quantize_add",
           "quantize_add_sr", "quantize_pack", "quantize_pack_sr",
           "hop_pack", "hop_pack_sr", "quantize_pack_blocked",
           "quantize_pack_blocked_sr", "hop_pack_blocked",
           "hop_pack_blocked_sr", "digest_rows", "sr_bits",
           "fused_block_ok", "core_wire_launcher", "core_digest_launcher",
           "quantize_cast_ref",
           "quantize_cast_sr_ref", "quantize_add_ref", "quantize_add_sr_ref",
           "quantize_pack_ref", "hop_pack_ref", "digest_rows_ref",
           "sr_bits_ref"]


# -- plain versions --------------------------------------------------------

def quantize_cast_ref(x: torch.Tensor, exp_bits: int,
                      man_bits: int) -> torch.Tensor:
    """Plain version of K1: the RTNE cast."""
    return cast_body(x, exp_bits, man_bits)


def quantize_cast_sr_ref(x: torch.Tensor, exp_bits: int, man_bits: int,
                         rbits: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the SR cast with round bits ``rbits``."""
    return cast_body_sr(x, exp_bits, man_bits, rbits)


def quantize_add_ref(x: torch.Tensor, y: torch.Tensor, exp_bits: int,
                     man_bits: int) -> torch.Tensor:
    """Plain version of K3: ``cast(x + y)``."""
    return cast_body(x + y, exp_bits, man_bits)


def quantize_add_sr_ref(x: torch.Tensor, y: torch.Tensor, exp_bits: int,
                        man_bits: int, rbits: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: ``cast_sr(x + y, rbits)``."""
    return cast_body_sr(x + y, exp_bits, man_bits, rbits)


def _cast_flat(s: torch.Tensor, exp_bits: int, man_bits: int, rbits):
    return (cast_body(s, exp_bits, man_bits) if rbits is None
            else cast_body_sr(s, exp_bits, man_bits, rbits.reshape(-1)))


def _cast_pack(s: torch.Tensor, exp_bits: int, man_bits: int, rbits,
               block_size) -> tuple:
    """``res = cast(s)`` and ``wire = pack(res)``: per tensor, or
    block-scaled with ``block_size`` (the wire then flat, codes and
    sidecar)."""
    if block_size is None:
        res = _cast_flat(s, exp_bits, man_bits, rbits)
        return res, pack_exmy(res, exp_bits, man_bits)
    if rbits is not None:
        rbits = rbits.reshape(-1)
    res = cast_body_blocked(s, exp_bits, man_bits, block_size, rbits)
    return res, pack_exmy_blocked(res, exp_bits, man_bits, block_size)


def quantize_pack_ref(g: torch.Tensor, exp_bits: int, man_bits: int, *,
                      rbits=None, block_size=None,
                      want_digest: bool = False) -> tuple:
    """Plain version of K6: ``res = cast(g)`` (SR with ``rbits``; block-
    scaled with ``block_size``), ``wire = pack(res)`` [,
    ``wire_digest(wire)``]."""
    res, wire = _cast_pack(g.reshape(-1), exp_bits, man_bits, rbits,
                           block_size)
    return (res, wire, wire_digest(wire)) if want_digest else (res, wire)


def hop_pack_ref(wire_in: torch.Tensor, g: torch.Tensor, exp_bits: int,
                 man_bits: int, *, rbits=None, block_size=None,
                 want_digest: bool = False) -> tuple:
    """Plain version of K5: ``res = cast(unpack(wire_in) + g)`` (SR with
    ``rbits``; block-scaled with ``block_size``), ``wire = pack(res)`` [,
    digests of ``wire_in`` and ``wire``]."""
    n = g.numel()
    if block_size is None:
        prev = unpack_exmy(wire_in.reshape(n, wire_bytes(exp_bits, man_bits)),
                           exp_bits, man_bits)
    else:
        prev = unpack_exmy_blocked(wire_in.reshape(-1), exp_bits, man_bits,
                                   n, block_size)
    res, wire = _cast_pack(prev + g.reshape(-1), exp_bits, man_bits, rbits,
                           block_size)
    if want_digest:
        return res, wire, wire_digest(wire_in), wire_digest(wire)
    return res, wire


def digest_rows_ref(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: the (W,) int64 `wire_digest` of each row of a
    (W, B) uint8 buffer."""
    return row_digests(rows)


def sr_bits_ref(key: tuple, like: torch.Tensor, *, offset_start: int = 0,
                flat: bool = False) -> torch.Tensor:
    """Plain version of `sr_bits`: ``prng.sr_bits_at(key, o)`` for the
    offsets ``offset_start + i`` of ``like``'s elements (``flat``:
    ``prng.random_bits(key, (n,))``, which has no offset), as a flat
    int32 tensor of uint32 patterns."""
    if flat:
        _flat_from_zero(offset_start)
        return to_int32_bits(random_bits(key, (like.numel(),), like.device))
    o = torch.arange(like.numel(), dtype=torch.int64,
                     device=like.device) + offset_start
    return to_int32_bits(sr_bits_at(key, o))


def _flat_from_zero(offset_start: int) -> None:
    if offset_start:
        raise ValueError(f"offset_start={offset_start} with flat=True: the "
                         "flat bits (jax.random.bits) start at index 0")


# -- the kernels -----------------------------------------------------------

def _device(*xs: torch.Tensor) -> torch.device:
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check(name: str, x: torch.Tensor, dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_block_ok(block_size: int) -> bool:
    """Does the blocked wire kernel take ``block_size``?  A multiple of
    128 dividing 65536, as the JAX kernel's whole-row blocks must be."""
    return block_size % 128 == 0 and 65536 % block_size == 0


def _check_block(block_size: int) -> None:
    if not fused_block_ok(block_size):
        raise ValueError(
            f"fused blocked hop needs block_size a multiple of 128 dividing "
            f"65536, got {block_size} — the plain torch hop "
            f"(parallel/ring.py) handles other sizes")


def _library():
    from .build import load_library

    lib = load_library("quantize")
    if not getattr(lib, "_cpd_typed", False):
        lib.quantize_cast_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.quantize_cast_launch.restype = ctypes.c_int
        lib.quantize_wire_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.quantize_wire_launch.restype = ctypes.c_int
        lib.quantize_sr_bits_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_uint, ctypes.c_void_p]
        lib.quantize_sr_bits_launch.restype = ctypes.c_int
        lib.quantize_flat_bits_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_void_p]
        lib.quantize_flat_bits_launch.restype = ctypes.c_int
        lib.quantize_wire_blocks.argtypes = [ctypes.c_longlong]
        lib.quantize_wire_blocks.restype = ctypes.c_int
        lib.quantize_blocked_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.quantize_blocked_launch.restype = ctypes.c_int
        lib.quantize_blocked_blocks.argtypes = [ctypes.c_longlong,
                                                ctypes.c_int]
        lib.quantize_blocked_blocks.restype = ctypes.c_int
        lib.quantize_run_launch.argtypes = lib.quantize_wire_launch.argtypes
        lib.quantize_run_launch.restype = ctypes.c_int
        lib.quantize_run_blocked_launch.argtypes = \
            lib.quantize_blocked_launch.argtypes
        lib.quantize_run_blocked_launch.restype = ctypes.c_int
        lib.quantize_run_scratch_words.argtypes = []
        lib.quantize_run_scratch_words.restype = ctypes.c_int
        lib.quantize_run_head.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.quantize_run_head.restype = ctypes.c_longlong
        lib.digest_rows_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.digest_rows_launch.restype = ctypes.c_int
        lib.digest_rows_ctas.argtypes = [ctypes.c_int, ctypes.c_longlong]
        lib.digest_rows_ctas.restype = ctypes.c_int
        lib.digest_rows_run_launch.argtypes = lib.digest_rows_launch.argtypes
        lib.digest_rows_run_launch.restype = ctypes.c_int
        lib.digest_rows_scratch_words.argtypes = [ctypes.c_int]
        lib.digest_rows_scratch_words.restype = ctypes.c_longlong
        lib.quantize_error_string.argtypes = [ctypes.c_int]
        lib.quantize_error_string.restype = ctypes.c_char_p
        lib._cpd_typed = True
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.quantize_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {rc})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_rbits(rbits: torch.Tensor, n: int) -> None:
    _check("rbits", rbits, torch.int32)
    if rbits.numel() != n:
        raise ValueError(f"rbits hold {rbits.numel()} values for {n} "
                         "elements")


def _launch_cast(x: torch.Tensor, y, rbits, exp_bits: int, man_bits: int,
                 what: str) -> torch.Tensor:
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.quantize_cast_launch(
            x.data_ptr(), _ptr(y), _ptr(rbits), out.data_ptr(), x.numel(),
            exp_bits, man_bits, _stream(x.device))
    _raise_on(lib, rc, what)
    return out


def quantize_cast(x: torch.Tensor, exp_bits: int,
                  man_bits: int) -> torch.Tensor:
    """RTNE eXmY cast of an fp32 tensor of any shape (K1).  CPU tensors
    take `quantize_cast_ref`; CUDA tensors launch the kernel, counted in
    ``quantize_cast.launches``."""
    _validate(exp_bits, man_bits)
    if _device(x).type == "cpu":
        return quantize_cast_ref(x, exp_bits, man_bits)
    _check("x", x, torch.float32)
    if x.numel() == 0:
        return x.clone()
    out = _launch_cast(x, None, None, exp_bits, man_bits, "quantize_cast")
    quantize_cast.launches += 1
    return out


def quantize_cast_sr(x: torch.Tensor, exp_bits: int, man_bits: int,
                     rbits: torch.Tensor) -> torch.Tensor:
    """Stochastically rounded eXmY cast of an fp32 tensor of any shape
    with one uint32 of round bits per element (K2).  CPU tensors take
    `quantize_cast_sr_ref`; CUDA tensors launch the kernel (``rbits``
    int32, contiguous, x's size), counted in
    ``quantize_cast_sr.launches``."""
    _validate(exp_bits, man_bits)
    if _device(x, rbits).type == "cpu":
        return quantize_cast_sr_ref(x, exp_bits, man_bits, rbits)
    _check("x", x, torch.float32)
    _check_rbits(rbits, x.numel())
    if x.numel() == 0:
        return x.clone()
    out = _launch_cast(x, None, rbits, exp_bits, man_bits,
                       "quantize_cast_sr")
    quantize_cast_sr.launches += 1
    return out


def _add_args(x: torch.Tensor, y: torch.Tensor, exp_bits: int,
              man_bits: int, *more) -> str:
    _validate(exp_bits, man_bits)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    return _device(x, y, *more).type


def quantize_add(x: torch.Tensor, y: torch.Tensor, exp_bits: int,
                 man_bits: int) -> torch.Tensor:
    """Fused ``cast(x + y)`` of two fp32 tensors of one shape (K3).  CPU
    tensors take `quantize_add_ref`; CUDA tensors launch the kernel,
    counted in ``quantize_add.launches``."""
    if _add_args(x, y, exp_bits, man_bits) == "cpu":
        return quantize_add_ref(x, y, exp_bits, man_bits)
    _check("x", x, torch.float32)
    _check("y", y, torch.float32)
    if x.numel() == 0:
        return x.clone()
    out = _launch_cast(x, y, None, exp_bits, man_bits, "quantize_add")
    quantize_add.launches += 1
    return out


def quantize_add_sr(x: torch.Tensor, y: torch.Tensor, exp_bits: int,
                    man_bits: int, rbits: torch.Tensor) -> torch.Tensor:
    """Fused ``cast_sr(x + y, rbits)`` (K4).  CPU tensors take
    `quantize_add_sr_ref`; CUDA tensors launch the kernel, counted in
    ``quantize_add_sr.launches``."""
    if _add_args(x, y, exp_bits, man_bits, rbits) == "cpu":
        return quantize_add_sr_ref(x, y, exp_bits, man_bits, rbits)
    _check("x", x, torch.float32)
    _check("y", y, torch.float32)
    _check_rbits(rbits, x.numel())
    if x.numel() == 0:
        return x.clone()
    out = _launch_cast(x, y, rbits, exp_bits, man_bits, "quantize_add_sr")
    quantize_add_sr.launches += 1
    return out


def sr_bits(key: tuple, like: torch.Tensor, *, offset_start: int = 0,
            flat: bool = False) -> torch.Tensor:
    """The SR round bits of ``like``'s elements: ``prng.sr_bits_at(key,
    o)`` at the offsets ``offset_start + i`` (mod 2^32), as a flat int32
    tensor of uint32 patterns on ``like``'s device.  ``flat=True`` draws
    ``jax.random.bits(key, shape)``'s bits instead (one threefry an
    element at its flat index from 0, the stream of
    `numerics.cast_to_format_sr`; ``flat_bits_kernel``), and refuses an
    ``offset_start``.  A CPU ``like`` takes `sr_bits_ref`; a CUDA one
    launches the kernel, counted in ``sr_bits.launches`` either way."""
    dev = _device(like)
    if dev.type == "cpu":
        return sr_bits_ref(key, like, offset_start=offset_start, flat=flat)
    if flat:
        _flat_from_zero(offset_start)
    n = like.numel()
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _library()
    keys = (key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF)
    with torch.cuda.device(dev):
        if flat:
            rc = lib.quantize_flat_bits_launch(out.data_ptr(), n, *keys,
                                               _stream(dev))
        else:
            rc = lib.quantize_sr_bits_launch(
                out.data_ptr(), n, offset_start & 0xFFFFFFFF, *keys,
                _stream(dev))
    _raise_on(lib, rc, "sr_bits")
    sr_bits.launches += 1
    return out


# the digesting K6/K5 launches' scratch (the digest sums the CTAs add to
# and the ticket they draw) by (device index, stream): launches on one
# stream run in turn and each leaves the sums and the ticket at 0, while
# two streams never share them
_WIRE_SCRATCH: dict = {}


def _wire_scratch(lib, dev: torch.device) -> torch.Tensor:
    """The current stream's scratch on ``dev``, zeroed at its first use
    (on that stream, so before any launch that takes it)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _WIRE_SCRATCH.get(key)
    if buf is None:
        buf = torch.zeros((lib.quantize_run_scratch_words(),),
                          dtype=torch.int32, device=dev)
        _WIRE_SCRATCH[key] = buf
    return buf


def _launch_wire(wire_in, g: torch.Tensor, rbits, exp_bits: int,
                 man_bits: int, block_size, want_digest: bool, what: str,
                 fold: bool = True) -> tuple:
    """One launch of the streaming K6/K5 kernel (per tensor, or blocked
    with ``block_size``) on checked CUDA tensors: ``(res, wire)`` or, with
    the digests the launch folds itself, ``(res, wire, digest_in,
    digest_out)``.  ``fold=False`` (digests only) is the timing form that
    stops at the CTAs' sums, drawing no ticket: its digests are not
    written."""
    n = g.numel()
    wb = wire_bytes(exp_bits, man_bits)
    dev = g.device
    res = torch.empty((n,), dtype=torch.float32, device=dev)
    wire = _wire_out(n, wb, exp_bits, man_bits, block_size, dev)
    lib = _library()
    scratch = digest = None
    if want_digest:
        scratch = _wire_scratch(lib, dev)
        digest = torch.empty((2,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        args = (_ptr(wire_in), g.data_ptr(), _ptr(rbits), res.data_ptr(),
                wire.data_ptr(), _ptr(scratch), _ptr(digest if fold else None),
                n)
        if block_size is None:
            rc = lib.quantize_run_launch(*args, wb, exp_bits, man_bits,
                                         _stream(dev))
        else:
            rc = lib.quantize_run_blocked_launch(
                *args, block_size, wb, exp_bits, man_bits, _stream(dev))
    _raise_on(lib, rc, what)
    if not want_digest:
        return res, wire
    return res, wire, digest[0], digest[1]


def _wire_out(n: int, wb: int, exp_bits: int, man_bits: int, block_size,
              dev) -> torch.Tensor:
    """The uninitialised emitted wire: (n, wb), or the flat blocked
    buffer."""
    if block_size is None:
        return torch.empty((n, wb), dtype=torch.uint8, device=dev)
    return torch.empty((wire_bytes_blocked(exp_bits, man_bits, n,
                                           block_size),),
                       dtype=torch.uint8, device=dev)


def _launch_core_wire(wire_in, g: torch.Tensor, rbits, exp_bits: int,
                      man_bits: int, block_size, want_digest: bool,
                      what: str) -> tuple:
    """`_launch_wire` on the kept kernels (``wire_kernel`` and
    ``blocked_wire_kernel``): a zero-filled digest, the launch and the
    one-CTA ``fold_kernel``."""
    n = g.numel()
    wb = wire_bytes(exp_bits, man_bits)
    dev = g.device
    res = torch.empty((n,), dtype=torch.float32, device=dev)
    wire = _wire_out(n, wb, exp_bits, man_bits, block_size, dev)
    lib = _library()
    blocks = (lib.quantize_wire_blocks(n) if block_size is None
              else lib.quantize_blocked_blocks(n, block_size))
    partials = digest = None
    if want_digest:
        partials = torch.empty((blocks * 4,), dtype=torch.int64, device=dev)
        digest = torch.zeros((2,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        if block_size is None:
            rc = lib.quantize_wire_launch(
                _ptr(wire_in), g.data_ptr(), _ptr(rbits), res.data_ptr(),
                wire.data_ptr(), _ptr(partials), _ptr(digest), n, wb,
                exp_bits, man_bits, _stream(dev))
        else:
            rc = lib.quantize_blocked_launch(
                _ptr(wire_in), g.data_ptr(), _ptr(rbits), res.data_ptr(),
                wire.data_ptr(), _ptr(partials), _ptr(digest), n,
                block_size, wb, exp_bits, man_bits, _stream(dev))
    _raise_on(lib, rc, what)
    if not want_digest:
        return res, wire
    d = digest.to(torch.int64) & 0xFFFFFFFF
    return res, wire, d[0], d[1]


def core_wire_launcher():
    """K6/K5's kept kernels, the yardstick the streaming kernels are timed
    against; no path calls them.  Returns ``fn(wire_in, g, exp_bits,
    man_bits, *, rbits=None, block_size=None, want_digest=False)`` with
    `quantize_pack`'s (``wire_in`` None) or `hop_pack`'s outputs, on CUDA
    tensors only, counting nothing."""
    def launch(wire_in, g, exp_bits, man_bits, *, rbits=None,
               block_size=None, want_digest=False):
        _wire_checks(wire_in, g, exp_bits, man_bits, block_size)
        if _device(*(t for t in (wire_in, g, rbits)
                     if t is not None)).type != "cuda" or g.numel() == 0:
            raise ValueError("the kept wire kernels take non-empty CUDA "
                             "tensors")
        _card_checks(wire_in, g, rbits)
        out = _launch_core_wire(wire_in, g, rbits, exp_bits, man_bits,
                                block_size, want_digest, "core wire")
        first = wire_in is None
        return out[:2] + (out[3],) if first and want_digest else out
    return launch


def _wire_checks(wire_in, g: torch.Tensor, exp_bits: int, man_bits: int,
                 block_size) -> None:
    """What K6/K5 take on every device: a wire format, a block size the
    blocked kernel takes, and a received wire of the emitted one's
    size."""
    _validate_wire(exp_bits, man_bits)
    n = g.numel()
    if block_size is None:
        expected = n * wire_bytes(exp_bits, man_bits)
        layout = f"{n} elements x {wire_bytes(exp_bits, man_bits)} bytes"
    else:
        if exp_bits == 8 and man_bits == 23:
            raise ValueError("block_size at (8, 23): the fp32 wire has "
                             "nothing to scale")
        _check_block(block_size)
        expected = wire_bytes_blocked(exp_bits, man_bits, n, block_size)
        layout = (f"{n} elements x {wire_bytes(exp_bits, man_bits)} bytes "
                  f"+ {sidecar_bytes(n, block_size)} sidecar bytes")
    if wire_in is not None and wire_in.numel() != expected:
        raise ValueError(f"wire_in holds {wire_in.numel()} bytes, expected "
                         f"{layout}")


def _card_checks(wire_in, g: torch.Tensor, rbits) -> None:
    """The kernels' operand types: contiguous uint8 / fp32 / int32."""
    if wire_in is not None:
        _check("wire_in", wire_in, torch.uint8)
    _check("g", g, torch.float32)
    if rbits is not None:
        _check_rbits(rbits, g.numel())


def _wire(wire_in, g: torch.Tensor, exp_bits: int, man_bits: int, rbits,
          block_size, want_digest: bool, counted) -> tuple:
    """The body of the K6 (``wire_in`` None) and K5 wrappers, per-tensor
    or blocked: the plain version for CPU tensors, else one launch of the
    streaming kernel, counted in ``counted.launches``."""
    _wire_checks(wire_in, g, exp_bits, man_bits, block_size)
    first = wire_in is None
    operands = [t for t in (wire_in, g, rbits) if t is not None]
    if _device(*operands).type == "cpu" or g.numel() == 0:
        kw = dict(rbits=rbits, block_size=block_size,
                  want_digest=want_digest)
        if first:
            return quantize_pack_ref(g, exp_bits, man_bits, **kw)
        return hop_pack_ref(wire_in, g, exp_bits, man_bits, **kw)
    _card_checks(wire_in, g, rbits)
    out = _launch_wire(wire_in, g, rbits, exp_bits, man_bits, block_size,
                       want_digest, "quantize_pack" if first else "hop_pack")
    counted.launches += 1
    return out[:2] + (out[3],) if first and want_digest else out


def _counter(first: bool, sr: bool, blocked: bool):
    """The object whose ``launches`` counts a K6/K5 launch of this arm."""
    name = (("quantize_pack" if first else "hop_pack")
            + ("_blocked" if blocked else "") + ("_sr" if sr else ""))
    return globals()[name]


def quantize_pack(g: torch.Tensor, exp_bits: int, man_bits: int, *,
                  rbits=None, block_size=None,
                  want_digest: bool = False) -> tuple:
    """The ring's hop 0, fused (K6): cast the local chunk ``g`` (SR with
    the round bits ``rbits``) and pack it.  Returns ``(res, wire)`` or
    ``(res, wire, digest)``: ``res`` the (n,) fp32 partial, ``wire`` the
    (n, wb) uint8 code words in `pack_exmy`'s layout, ``digest``
    `wire_digest(wire)`.  With ``block_size`` the wire is the flat
    block-scaled buffer (`pack_exmy_blocked`'s layout: code bytes, then
    one sidecar byte per block).  CPU tensors take `quantize_pack_ref`;
    CUDA tensors launch the kernel, counted in ``quantize_pack.launches``
    (``_sr`` with ``rbits``, ``_blocked`` with ``block_size``: e.g.
    ``quantize_pack_blocked_sr.launches``)."""
    return _wire(None, g, exp_bits, man_bits, rbits, block_size,
                 want_digest,
                 _counter(True, rbits is not None, block_size is not None))


def quantize_pack_sr(g: torch.Tensor, exp_bits: int, man_bits: int,
                     rbits: torch.Tensor, *, block_size=None,
                     want_digest: bool = False) -> tuple:
    """The SR arm of K6: ``quantize_pack(g, ..., rbits=rbits)``."""
    return quantize_pack(g, exp_bits, man_bits, rbits=rbits,
                         block_size=block_size, want_digest=want_digest)


def hop_pack(wire_in: torch.Tensor, g: torch.Tensor, exp_bits: int,
             man_bits: int, *, rbits=None, block_size=None,
             want_digest: bool = False) -> tuple:
    """One fused ring hop over the packed wire (K5): unpack ``wire_in``
    ((n, wb) uint8), add the local chunk ``g`` ((n,) fp32), cast (SR with
    the round bits ``rbits``), re-pack.  Returns ``(res, wire)`` or
    ``(res, wire, digest_in, digest_out)``.  With ``block_size`` both
    wires are flat block-scaled buffers (`quantize_pack`).  CPU tensors
    take `hop_pack_ref`; CUDA tensors launch the kernel, counted in
    ``hop_pack.launches`` (``_sr`` with ``rbits``, ``_blocked`` with
    ``block_size``)."""
    return _wire(wire_in, g, exp_bits, man_bits, rbits, block_size,
                 want_digest,
                 _counter(False, rbits is not None, block_size is not None))


def hop_pack_sr(wire_in: torch.Tensor, g: torch.Tensor, exp_bits: int,
                man_bits: int, rbits: torch.Tensor, *, block_size=None,
                want_digest: bool = False) -> tuple:
    """The SR arm of K5: ``hop_pack(wire_in, g, ..., rbits=rbits)``."""
    return hop_pack(wire_in, g, exp_bits, man_bits, rbits=rbits,
                    block_size=block_size, want_digest=want_digest)


def _rows_arg(rows: torch.Tensor) -> None:
    if rows.dim() != 2:
        raise ValueError(f"digest_rows wants (W, n_bytes) uint8, got shape "
                         f"{tuple(rows.shape)}")


# K7's launches' scratch (the ticket and one 64-bit sum per row) by
# (device index, stream), grown with the row count; as `_WIRE_SCRATCH`
_ROW_SCRATCH: dict = {}


def _row_scratch(lib, dev: torch.device, w: int) -> torch.Tensor:
    """The current stream's K7 scratch on ``dev`` for ``w`` rows, zeroed
    when it is made; a larger one replaces it (the stream's pending
    launches keep the old buffer, which the caching allocator hands out
    again only in the stream's order)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    words = lib.digest_rows_scratch_words(w)
    buf = _ROW_SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros((words,), dtype=torch.int32, device=dev)
        _ROW_SCRATCH[key] = buf
    return buf


def digest_rows(rows: torch.Tensor) -> torch.Tensor:
    """The (W,) int64 `wire_digest` of each row of a (W, B) uint8 buffer
    (K7).  CPU tensors take `digest_rows_ref`; CUDA tensors launch the
    kernel once, counted in ``digest_rows.launches``."""
    _rows_arg(rows)
    dev = _device(rows)
    w, nb = rows.shape
    if dev.type == "cpu" or w == 0 or nb == 0:
        return digest_rows_ref(rows)
    _check("rows", rows, torch.uint8)
    lib = _library()
    out = torch.empty((w,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.digest_rows_run_launch(rows.data_ptr(), w, nb,
                                        _row_scratch(lib, dev, w).data_ptr(),
                                        out.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "digest_rows")
    digest_rows.launches += 1
    return out


def core_digest_launcher():
    """K7's kept kernels (``digest_rows_kernel`` and its ``fold_kernel<2>``
    launch, with the wrapper's partials tensor and its int64 widening),
    the yardstick the one-launch kernel is timed against; no path calls
    them.  Returns ``fn(rows)`` with `digest_rows`'s output, on non-empty
    CUDA tensors only, counting nothing."""
    def launch(rows):
        _rows_arg(rows)
        w, nb = rows.shape
        if _device(rows).type != "cuda" or w == 0 or nb == 0:
            raise ValueError("the kept digest kernel takes non-empty CUDA "
                             "tensors")
        _check("rows", rows, torch.uint8)
        dev = rows.device
        lib = _library()
        partials = torch.empty((w * lib.digest_rows_ctas(w, nb) * 2,),
                               dtype=torch.int64, device=dev)
        out = torch.empty((w,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.digest_rows_launch(rows.data_ptr(), w, nb,
                                        partials.data_ptr(), out.data_ptr(),
                                        _stream(dev))
        _raise_on(lib, rc, "core digest_rows")
        return out.to(torch.int64) & 0xFFFFFFFF
    return launch


for _fn in (quantize_cast, quantize_cast_sr, quantize_add, quantize_add_sr,
            quantize_pack, quantize_pack_sr, hop_pack, hop_pack_sr,
            digest_rows, sr_bits):
    _fn.launches = 0
del _fn

# The blocked arms of K6 and K5 launch through `quantize_pack` and
# `hop_pack`; their launches are counted here.
quantize_pack_blocked = SimpleNamespace(launches=0)
quantize_pack_blocked_sr = SimpleNamespace(launches=0)
hop_pack_blocked = SimpleNamespace(launches=0)
hop_pack_blocked_sr = SimpleNamespace(launches=0)
