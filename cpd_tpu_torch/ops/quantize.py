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
  `hop_pack_sr`), re-pack (+ the digests of both wires).

and of one helper that is no TPU kernel (JAX computes it in XLA):
`sr_bits`, the offset-indexed SR round bits ``prng.sr_bits_at(key, o)``
that K2/K4/K5/K6 take as their operand.  The SR kernels take the bits as
int32 tensors holding the uint32 patterns (`prng.to_int32_bits`).

Each wrapper takes the plain PyTorch version (``*_ref``, the same
function in torch ops) for CPU tensors and launches its hand-written
kernel in ``csrc/quantize.cu`` (built at first use, `ops.build`) for CUDA
tensors, or raises.  There is no fallback from the card to the plain
version.  Each wrapper counts its launches in ``<wrapper>.launches``;
the SR arms of K6 and K5 count theirs in ``quantize_pack_sr.launches``
and ``hop_pack_sr.launches`` only, whichever name the caller used.

Digests come back as int64 scalars holding the JAX package's uint32
values, as everywhere in the port.  The block-scaled wire
(``block_size``) of K5/K6 is not ported yet (ROADMAP Queue B, B3) and
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.integrity import wire_digest
from ..quant.numerics import (_validate, _validate_wire, cast_body,
                              cast_body_sr, pack_exmy, unpack_exmy,
                              wire_bytes)
from ..quant.prng import sr_bits_at, to_int32_bits

__all__ = ["quantize_cast", "quantize_cast_sr", "quantize_add",
           "quantize_add_sr", "quantize_pack", "quantize_pack_sr",
           "hop_pack", "hop_pack_sr", "sr_bits",
           "quantize_cast_ref", "quantize_cast_sr_ref", "quantize_add_ref",
           "quantize_add_sr_ref", "quantize_pack_ref", "hop_pack_ref",
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


def quantize_pack_ref(g: torch.Tensor, exp_bits: int, man_bits: int, *,
                      rbits=None, want_digest: bool = False) -> tuple:
    """Plain version of K6: ``res = cast(g)`` (SR with ``rbits``),
    ``wire = pack(res)`` [, ``wire_digest(wire)``]."""
    res = _cast_flat(g.reshape(-1), exp_bits, man_bits, rbits)
    wire = pack_exmy(res, exp_bits, man_bits)
    return (res, wire, wire_digest(wire)) if want_digest else (res, wire)


def hop_pack_ref(wire_in: torch.Tensor, g: torch.Tensor, exp_bits: int,
                 man_bits: int, *, rbits=None,
                 want_digest: bool = False) -> tuple:
    """Plain version of K5: ``res = cast(unpack(wire_in) + g)`` (SR with
    ``rbits``), ``wire = pack(res)`` [, digests of ``wire_in`` and
    ``wire``]."""
    n = g.numel()
    prev = unpack_exmy(wire_in.reshape(n, wire_bytes(exp_bits, man_bits)),
                       exp_bits, man_bits)
    res = _cast_flat(prev + g.reshape(-1), exp_bits, man_bits, rbits)
    wire = pack_exmy(res, exp_bits, man_bits)
    if want_digest:
        return res, wire, wire_digest(wire_in), wire_digest(wire)
    return res, wire


def sr_bits_ref(key: tuple, like: torch.Tensor, *,
                offset_start: int = 0) -> torch.Tensor:
    """Plain version of `sr_bits`: ``prng.sr_bits_at(key, o)`` for the
    offsets ``offset_start + i`` of ``like``'s elements, as a flat int32
    tensor of uint32 patterns."""
    o = torch.arange(like.numel(), dtype=torch.int64,
                     device=like.device) + offset_start
    return to_int32_bits(sr_bits_at(key, o))


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


def _unported(block_size) -> None:
    if block_size is not None:
        raise NotImplementedError(
            "the block-scaled wire (block_size) is not ported yet (ROADMAP "
            "Queue B, B3: the blocked arm of K5/K6)")


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
        lib.quantize_wire_blocks.argtypes = [ctypes.c_longlong]
        lib.quantize_wire_blocks.restype = ctypes.c_int
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


def sr_bits(key: tuple, like: torch.Tensor, *,
            offset_start: int = 0) -> torch.Tensor:
    """The SR round bits of ``like``'s elements: ``prng.sr_bits_at(key,
    o)`` at the offsets ``offset_start + i`` (mod 2^32), as a flat int32
    tensor of uint32 patterns on ``like``'s device.  A CPU ``like`` takes
    `sr_bits_ref`; a CUDA one launches the kernel, counted in
    ``sr_bits.launches``."""
    dev = _device(like)
    if dev.type == "cpu":
        return sr_bits_ref(key, like, offset_start=offset_start)
    n = like.numel()
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.quantize_sr_bits_launch(
            out.data_ptr(), n, offset_start & 0xFFFFFFFF,
            key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF, _stream(dev))
    _raise_on(lib, rc, "sr_bits")
    sr_bits.launches += 1
    return out


def _launch_wire(wire_in, g: torch.Tensor, rbits, exp_bits: int,
                 man_bits: int, want_digest: bool, what: str) -> tuple:
    n = g.numel()
    wb = wire_bytes(exp_bits, man_bits)
    dev = g.device
    res = torch.empty((n,), dtype=torch.float32, device=dev)
    wire = torch.empty((n, wb), dtype=torch.uint8, device=dev)
    lib = _library()
    partials = digest = None
    if want_digest:
        partials = torch.empty((lib.quantize_wire_blocks(n) * 4,),
                               dtype=torch.int64, device=dev)
        digest = torch.zeros((2,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.quantize_wire_launch(
            _ptr(wire_in), g.data_ptr(), _ptr(rbits), res.data_ptr(),
            wire.data_ptr(), _ptr(partials), _ptr(digest), n, wb, exp_bits,
            man_bits, _stream(dev))
    _raise_on(lib, rc, what)
    if not want_digest:
        return res, wire
    d = digest.to(torch.int64) & 0xFFFFFFFF
    return res, wire, d[0], d[1]


def _wire(wire_in, g: torch.Tensor, exp_bits: int, man_bits: int, rbits,
          block_size, want_digest: bool, counted) -> tuple:
    """The body of the K6 (``wire_in`` None) and K5 wrappers: the plain
    version for CPU tensors, else one launch, counted in
    ``counted.launches``."""
    _unported(block_size)
    _validate_wire(exp_bits, man_bits)
    n = g.numel()
    first = wire_in is None
    if not first and wire_in.numel() != n * wire_bytes(exp_bits, man_bits):
        raise ValueError(f"wire_in holds {wire_in.numel()} bytes, expected "
                         f"{n} elements x {wire_bytes(exp_bits, man_bits)} "
                         "bytes")
    operands = [t for t in (wire_in, g, rbits) if t is not None]
    if _device(*operands).type == "cpu" or n == 0:
        if first:
            return quantize_pack_ref(g, exp_bits, man_bits, rbits=rbits,
                                     want_digest=want_digest)
        return hop_pack_ref(wire_in, g, exp_bits, man_bits, rbits=rbits,
                            want_digest=want_digest)
    if not first:
        _check("wire_in", wire_in, torch.uint8)
    _check("g", g, torch.float32)
    if rbits is not None:
        _check_rbits(rbits, n)
    out = _launch_wire(wire_in, g, rbits, exp_bits, man_bits, want_digest,
                       counted.__name__)
    counted.launches += 1
    return out[:2] + (out[3],) if first and want_digest else out


def quantize_pack(g: torch.Tensor, exp_bits: int, man_bits: int, *,
                  rbits=None, block_size=None,
                  want_digest: bool = False) -> tuple:
    """The ring's hop 0, fused (K6): cast the local chunk ``g`` (SR with
    the round bits ``rbits``) and pack it.  Returns ``(res, wire)`` or
    ``(res, wire, digest)``: ``res`` the (n,) fp32 partial, ``wire`` the
    (n, wb) uint8 code words in `pack_exmy`'s layout, ``digest``
    `wire_digest(wire)`.  CPU tensors take `quantize_pack_ref`; CUDA
    tensors launch the kernel, counted in ``quantize_pack.launches``, or
    with ``rbits`` in ``quantize_pack_sr.launches``."""
    return _wire(None, g, exp_bits, man_bits, rbits, block_size,
                 want_digest,
                 quantize_pack if rbits is None else quantize_pack_sr)


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
    ``(res, wire, digest_in, digest_out)``.  CPU tensors take
    `hop_pack_ref`; CUDA tensors launch the kernel, counted in
    ``hop_pack.launches``, or with ``rbits`` in ``hop_pack_sr.launches``."""
    return _wire(wire_in, g, exp_bits, man_bits, rbits, block_size,
                 want_digest, hop_pack if rbits is None else hop_pack_sr)


def hop_pack_sr(wire_in: torch.Tensor, g: torch.Tensor, exp_bits: int,
                man_bits: int, rbits: torch.Tensor, *, block_size=None,
                want_digest: bool = False) -> tuple:
    """The SR arm of K5: ``hop_pack(wire_in, g, ..., rbits=rbits)``."""
    return hop_pack(wire_in, g, exp_bits, man_bits, rbits=rbits,
                    block_size=block_size, want_digest=want_digest)


for _fn in (quantize_cast, quantize_cast_sr, quantize_add, quantize_add_sr,
            quantize_pack, quantize_pack_sr, hop_pack, hop_pack_sr, sr_bits):
    _fn.launches = 0
del _fn
