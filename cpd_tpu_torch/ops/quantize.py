"""The eXmY quantize kernels of the gradient reduce, and their plain versions.

Port of the four TPU kernels of `cpd_tpu/ops/quantize.py` that the
data-parallel training path runs (RTNE, per-tensor, clean transport):

* `quantize_cast` (K1, `quantize_pallas`) — ``cast_body(x)``, the APS
  pre-quantize of every gradient leaf;
* `quantize_add` (K3, `quantize_add_pallas`) — ``cast_body(x + y)``, one
  step of the faithful ordered scan and the ring hop on an unpacked wire;
* `quantize_pack` (K6, `quantize_pack_pallas`) — the ring's hop 0: cast
  the local chunk and pack it into the ``(n, wb)`` wire (+ its digest);
* `hop_pack` (K5, `hop_pack_pallas`) — every later hop: unpack the
  received wire, add the local chunk, cast, re-pack (+ the digests of
  both wires).

Each wrapper takes the plain PyTorch version (``*_ref``, the same
function in torch ops) for CPU tensors and launches its hand-written
kernel in ``csrc/quantize.cu`` (built at first use, `ops.build`) for CUDA
tensors, or raises.  There is no fallback from the card to the plain
version.  Each wrapper counts its launches in ``<wrapper>.launches``.

Digests come back as int64 scalars holding the JAX package's uint32
values, as everywhere in the port.  The stochastic-rounding operand
(``rbits``) and the block-scaled wire (``block_size``) of K5/K6 are not
ported yet (ROADMAP Queue B, B2/B3) and raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.integrity import wire_digest
from ..quant.numerics import (_validate, _validate_wire, cast_body,
                              pack_exmy, unpack_exmy, wire_bytes)

__all__ = ["quantize_cast", "quantize_add", "quantize_pack", "hop_pack",
           "quantize_cast_ref", "quantize_add_ref", "quantize_pack_ref",
           "hop_pack_ref"]


# -- plain versions --------------------------------------------------------

def quantize_cast_ref(x: torch.Tensor, exp_bits: int,
                      man_bits: int) -> torch.Tensor:
    """Plain version of K1: the RTNE cast."""
    return cast_body(x, exp_bits, man_bits)


def quantize_add_ref(x: torch.Tensor, y: torch.Tensor, exp_bits: int,
                     man_bits: int) -> torch.Tensor:
    """Plain version of K3: ``cast(x + y)``."""
    return cast_body(x + y, exp_bits, man_bits)


def quantize_pack_ref(g: torch.Tensor, exp_bits: int, man_bits: int, *,
                      want_digest: bool = False) -> tuple:
    """Plain version of K6: ``res = cast(g)``, ``wire = pack(res)``
    [, ``wire_digest(wire)``]."""
    res = cast_body(g.reshape(-1), exp_bits, man_bits)
    wire = pack_exmy(res, exp_bits, man_bits)
    return (res, wire, wire_digest(wire)) if want_digest else (res, wire)


def hop_pack_ref(wire_in: torch.Tensor, g: torch.Tensor, exp_bits: int,
                 man_bits: int, *, want_digest: bool = False) -> tuple:
    """Plain version of K5: ``res = cast(unpack(wire_in) + g)``,
    ``wire = pack(res)`` [, digests of ``wire_in`` and ``wire``]."""
    n = g.numel()
    prev = unpack_exmy(wire_in.reshape(n, wire_bytes(exp_bits, man_bits)),
                       exp_bits, man_bits)
    res = cast_body(prev + g.reshape(-1), exp_bits, man_bits)
    wire = pack_exmy(res, exp_bits, man_bits)
    if want_digest:
        return res, wire, wire_digest(wire_in), wire_digest(wire)
    return res, wire


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


def _unported(rbits, block_size) -> None:
    if rbits is not None:
        raise NotImplementedError(
            "stochastic rounding (rbits) of the wire kernels is not ported "
            "yet (ROADMAP Queue B, B3: the SR arm of K5/K6)")
    if block_size is not None:
        raise NotImplementedError(
            "the block-scaled wire (block_size) is not ported yet (ROADMAP "
            "Queue B, B3: the blocked arm of K5/K6)")


def _library():
    from .build import load_library

    lib = load_library("quantize")
    if not getattr(lib, "_cpd_typed", False):
        lib.quantize_cast_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.quantize_cast_launch.restype = ctypes.c_int
        lib.quantize_wire_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.quantize_wire_launch.restype = ctypes.c_int
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


def _launch_cast(x: torch.Tensor, y, exp_bits: int, man_bits: int,
                 what: str) -> torch.Tensor:
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.quantize_cast_launch(
            x.data_ptr(), None if y is None else y.data_ptr(),
            out.data_ptr(), x.numel(), exp_bits, man_bits, _stream(x.device))
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
    out = _launch_cast(x, None, exp_bits, man_bits, "quantize_cast")
    quantize_cast.launches += 1
    return out


def quantize_add(x: torch.Tensor, y: torch.Tensor, exp_bits: int,
                 man_bits: int) -> torch.Tensor:
    """Fused ``cast(x + y)`` of two fp32 tensors of one shape (K3).  CPU
    tensors take `quantize_add_ref`; CUDA tensors launch the kernel,
    counted in ``quantize_add.launches``."""
    _validate(exp_bits, man_bits)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if _device(x, y).type == "cpu":
        return quantize_add_ref(x, y, exp_bits, man_bits)
    _check("x", x, torch.float32)
    _check("y", y, torch.float32)
    if x.numel() == 0:
        return x.clone()
    out = _launch_cast(x, y, exp_bits, man_bits, "quantize_add")
    quantize_add.launches += 1
    return out


def _launch_wire(wire_in, g: torch.Tensor, exp_bits: int, man_bits: int,
                 want_digest: bool, what: str) -> tuple:
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
            None if wire_in is None else wire_in.data_ptr(), g.data_ptr(),
            res.data_ptr(), wire.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if digest is None else digest.data_ptr(),
            n, wb, exp_bits, man_bits, _stream(dev))
    _raise_on(lib, rc, what)
    if not want_digest:
        return res, wire
    d = digest.to(torch.int64) & 0xFFFFFFFF
    return res, wire, d[0], d[1]


def quantize_pack(g: torch.Tensor, exp_bits: int, man_bits: int, *,
                  rbits=None, block_size=None,
                  want_digest: bool = False) -> tuple:
    """The ring's hop 0, fused (K6): cast the local chunk ``g`` and pack
    it.  Returns ``(res, wire)`` or ``(res, wire, digest)``: ``res`` the
    (n,) fp32 partial, ``wire`` the (n, wb) uint8 code words in
    `pack_exmy`'s layout, ``digest`` `wire_digest(wire)`.  CPU tensors
    take `quantize_pack_ref`; CUDA tensors launch the kernel, counted in
    ``quantize_pack.launches``."""
    _unported(rbits, block_size)
    _validate_wire(exp_bits, man_bits)
    if _device(g).type == "cpu":
        return quantize_pack_ref(g, exp_bits, man_bits,
                                 want_digest=want_digest)
    _check("g", g, torch.float32)
    if g.numel() == 0:
        return quantize_pack_ref(g, exp_bits, man_bits,
                                 want_digest=want_digest)
    out = _launch_wire(None, g, exp_bits, man_bits, want_digest,
                       "quantize_pack")
    quantize_pack.launches += 1
    return out[:2] + (out[3],) if want_digest else out


def hop_pack(wire_in: torch.Tensor, g: torch.Tensor, exp_bits: int,
             man_bits: int, *, rbits=None, block_size=None,
             want_digest: bool = False) -> tuple:
    """One fused ring hop over the packed wire (K5): unpack ``wire_in``
    ((n, wb) uint8), add the local chunk ``g`` ((n,) fp32), cast, re-pack.
    Returns ``(res, wire)`` or ``(res, wire, digest_in, digest_out)``.
    CPU tensors take `hop_pack_ref`; CUDA tensors launch the kernel,
    counted in ``hop_pack.launches``."""
    _unported(rbits, block_size)
    _validate_wire(exp_bits, man_bits)
    n = g.numel()
    wb = wire_bytes(exp_bits, man_bits)
    if wire_in.numel() != n * wb:
        raise ValueError(f"wire_in holds {wire_in.numel()} bytes, expected "
                         f"{n} elements x {wb} bytes")
    if _device(wire_in, g).type == "cpu":
        return hop_pack_ref(wire_in, g, exp_bits, man_bits,
                            want_digest=want_digest)
    _check("wire_in", wire_in, torch.uint8)
    _check("g", g, torch.float32)
    if n == 0:
        return hop_pack_ref(wire_in, g, exp_bits, man_bits,
                            want_digest=want_digest)
    out = _launch_wire(wire_in, g, exp_bits, man_bits, want_digest,
                       "hop_pack")
    hop_pack.launches += 1
    return out


for _fn in (quantize_cast, quantize_add, quantize_pack, hop_pack):
    _fn.launches = 0
del _fn
