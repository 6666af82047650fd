"""GQA-native flash attention (K9 forward, K10 backward) and their plain
versions.

Port of `cpd_tpu/ops/flash_gqa.py`: grouped queries q (B, Tq, H, D)
against unexpanded k/v (B, Tk, H_kv, D), kv head g serving query heads
[g·rep, (g+1)·rep), fp32 softmax.  Masked probabilities are zeroed by the
mask, pad keys and fully masked rows give 0, and the forward emits the
per-row log-sum-exp the backward re-exponentiates.

* `flash_gqa_fwd_ref` / `flash_gqa_bwd_ref` — the plain versions: the
  same recipe in torch ops over the whole score matrix (logits, mask,
  max, LSE; then p = exp(s − lse), dp, ds = p·(dp − delta)·scale and the
  products), for CPU tensors and the kernels' checks;
* `flash_gqa_fwd` (K9) / `flash_gqa_bwd` (K10) — the wrappers.  CPU
  tensors take the plain versions; CUDA tensors launch hand-written
  tensor-core kernels (built at first use, `ops.build`) or raise: fp32
  the 3xTF32 kernels of ``csrc/flash_f32_tc.cu`` (`_f32tc_fwd`,
  `_f32tc_bwd`), bf16 the ``mma.sync`` bf16 kernels of
  ``csrc/flash_mha_tc.cu`` (`_tc_fwd`, `_tc_bwd`), which K11 shares at
  rep = 1.  ``flash_gqa_fwd.launches`` counts forward launches and
  ``flash_gqa_bwd.launches`` backward calls (each launches the dq and the
  dk/dv kernel, and at rep > 1 the rep sum);
* `core_launchers` — the CUDA-core templates of ``csrc/flash_gqa.cu``,
  which no path calls in either dtype at head_dim <= 128:
  ``chip_smoke.py`` times them beside the tensor-core kernels;
* `launchers` — the launch functions a CUDA call of an element type and
  head_dim takes (the tensor-core kernels up to 128, the templates at
  256, the head_dim-split arm of ``flash_gqa.cu`` past 256), and
  `_padded_head_dim`, which runs one of them (or a plain version) on
  head dims zero-padded up to the kernel's;
* `flash_gqa(q, k, v, causal, bwd)` — the differentiable function.
  ``bwd="pallas"`` (the JAX name of the flash-backward kernels) saves
  (q, k, v, out, lse) and runs K10; ``bwd="chunked"`` recomputes through
  `attention._chunked_attention` under torch autograd.

``lse`` is (B, H, Tq): the JAX kernel's (B, H_kv, rep, Tq_p) without the
TPU's row padding.  Elements are fp32 or bf16, as the JAX kernel takes
q's dtype: logits, softmax and products accumulate in fp32, p is rounded
to the element type before p·v (its fp32 value feeds the sum), p and ds
before the backward's products, and each output once.  Both tensor-core
libraries at rep = 1 are K11, the stock MHA kernel (`ops.flash_mha`).

Head dims on the card.  Any head_dim runs.  The kernels are built for
head_dim 32, 64 and 128 (the tensor-core kernels), 256 (``flash_gqa.cu``'s
templates) and any multiple of 128 past 256 (``flash_gqa.cu``'s
head_dim-split arm: a grid axis over 128-column chunks of D).  Any other
head_dim is zero-padded to the next of these (`kernel_head_dim`), as the
JAX kernel pads D to a multiple of 128: q, k, v (and out, dout) get zero
columns, the kernel runs with the ORIGINAL head_dim's scale, and out, dq,
dk and dv are sliced back; lse is unchanged.  A padded column adds
x · 0 = +0 to every dot product, so the result is the unpadded one up to
the order of fp32 sums.  The batch is not limited: the launchers run a
batch past the grid's 65535 rows in chunks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .attention import _NEG_INF, _gqa_rep

__all__ = ["flash_gqa", "flash_gqa_fwd", "flash_gqa_bwd",
           "flash_gqa_fwd_ref", "flash_gqa_bwd_ref", "KERNEL_HEAD_DIMS",
           "KERNEL_DTYPES", "F32TC_SIGNATURES", "TC_SIGNATURES",
           "core_launchers", "launchers", "kernel_head_dim", "SPLIT_CHUNK"]

# the head dims the kernels are built for: the tensor-core kernels take
# the first three, flash_gqa.cu's templates the last
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
TC_HEAD_DIMS = KERNEL_HEAD_DIMS[:3]
# columns of a D chunk of the head_dim-split arm: it takes the multiples
# of this past KERNEL_HEAD_DIMS[-1]
SPLIT_CHUNK = 128
# element type -> the kernels' dtype code
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/flash_f32_tc.cu's C interface: name -> (restype, argtypes)
F32TC_SIGNATURES = {
    "flash_f32tc_fwd_launch": (_I, [_P] * 5 + [_I] * 7 + [_F, _P]),
    "flash_f32tc_bwd_launch": (_I, [_P] * 11 + [_I] * 7 + [_F, _P]),
    "flash_f32tc_smem_bytes": (_I, [_I, _I]),
    "flash_error_string": (ctypes.c_char_p, [_I]),
}
# csrc/flash_mha_tc.cu's C interface (the bf16 kernels of K9-K11)
TC_SIGNATURES = {
    "flash_tc_fwd_launch": (_I, [_P] * 5 + [_I] * 7 + [_F, _P]),
    "flash_tc_bwd_launch": (_I, [_P] * 11 + [_I] * 7 + [_F, _P]),
    "flash_tc_smem_bytes": (_I, [_I, _I]),
    "flash_error_string": (ctypes.c_char_p, [_I]),
}


def _scale(d: int) -> float:
    """``1.0 / float(d) ** 0.5`` in fp32, the JAX kernel's scale."""
    return float(np.float32(1.0 / float(d) ** 0.5))


def kernel_head_dim(d: int) -> int:
    """The head_dim of the kernel a CUDA call of head_dim ``d`` runs: the
    least of `KERNEL_HEAD_DIMS` >= d, and past them the JAX kernel's own
    rule, the next multiple of 128 (the head_dim-split arm)."""
    for k in KERNEL_HEAD_DIMS:
        if d <= k:
            return k
    return -(-d // SPLIT_CHUNK) * SPLIT_CHUNK


def _padded_head_dim(fn, xs: tuple, *args):
    """``fn(*xs, *args)`` with head_dim zero-padded to
    `kernel_head_dim`: every (B, T, heads, D) tensor of ``xs`` gets zero
    columns up to it, ``fn`` runs with the original D's scale
    (``scale=``), and its (B, T, heads, D) outputs are sliced back to D;
    lse and the other 3-d tensors pass as they are.  At a kernel's own
    head_dim it is ``fn(*xs, *args)``.  ``fn`` is a launcher or a plain
    version: the CPU tests hold this path itself against the JAX
    kernels."""
    d = xs[0].shape[-1]
    d_p = kernel_head_dim(d)
    if d_p == d:
        return fn(*xs, *args)
    padded = (F.pad(x, (0, d_p - d)) if x.dim() == 4 else x for x in xs)
    res = fn(*padded, *args, scale=_scale(d))
    return tuple(r[..., :d].contiguous() if r.dim() == 4 else r
                 for r in res)


def _valid(tq: int, tk: int, causal: bool, device) -> torch.Tensor:
    qi = torch.arange(tq, device=device)[:, None]
    ki = torch.arange(tk, device=device)[None, :]
    return (qi >= ki) if causal else torch.ones((tq, tk), dtype=torch.bool,
                                                device=device)


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to ``dtype`` (the element type), in fp32."""
    return x.to(dtype).float()


def _grouped_logits(q, k, scale):
    """(B, H_kv, rep, Tq, Tk) fp32 logits * scale."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, tq, hkv, h // hkv, d)
    return torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale


def flash_gqa_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale=None) -> tuple:
    """Plain version of K9: ``(out (B, Tq, H, D), lse (B, H, Tq))``;
    ``scale`` defaults to `_scale` of q's head_dim."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    _gqa_rep(q, k)
    valid = _valid(tq, tk, causal, q.device)
    scale = _scale(d) if scale is None else scale
    s = torch.where(valid, _grouped_logits(q, k, scale), _NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if tk else torch.full(
        s.shape[:-1] + (1,), _NEG_INF, device=q.device)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bgrqk,bkgd->bqgrd", _rounded(p, v.dtype),
                       v.float()) / den.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(den))[..., 0]
    return out.reshape(b, tq, h, d).to(q.dtype), lse.reshape(b, h, tq)


def flash_gqa_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, causal: bool = True,
                      scale=None) -> tuple:
    """Plain version of K10: ``(dq, dk, dv)`` in the input shapes;
    ``scale`` defaults to `_scale` of q's head_dim."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = _gqa_rep(q, k)
    scale = _scale(d) if scale is None else scale
    valid = _valid(tq, tk, causal, q.device)
    delta = _delta(out, dout).reshape(b, hkv, rep, tq)
    lse = lse.reshape(b, hkv, rep, tq)
    s = _grouped_logits(q, k, scale)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dg = dout.float().reshape(b, tq, hkv, rep, d)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dg, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bgrqk,bkgd->bqgrd", _rounded(ds, k.dtype),
                      k.float()).reshape(b, tq, h, d)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", _rounded(ds, q.dtype),
                      q.float().reshape(b, tq, hkv, rep, d))
    dv = torch.einsum("bgrqk,bqgrd->bkgd", _rounded(p, dout.dtype), dg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """(B, H, Tq) fp32 Σ_d dout·out, the backward's row constant."""
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1)


def _library():
    from .build import load_library

    lib = load_library("flash_gqa")
    if not getattr(lib, "_cpd_typed", False):
        lib.flash_fwd_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_fwd_launch.restype = ctypes.c_int
        lib.flash_bwd_launch.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_bwd_launch.restype = ctypes.c_int
        for fn in ("fwd", "bwd"):
            split = getattr(lib, f"flash_split_{fn}_launch")
            core = getattr(lib, f"flash_{fn}_launch")
            split.argtypes, split.restype = core.argtypes, core.restype
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._cpd_typed = True
    return lib


def _typed_library(name: str, signatures: dict):
    """The loaded library of kernel ``name`` (built at first use), its
    functions typed by ``signatures``: name -> (restype, argtypes)."""
    from .build import load_library

    lib = load_library(name)
    if not getattr(lib, "_cpd_typed", False):
        for fn_name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.restype, fn.argtypes = restype, argtypes
        lib._cpd_typed = True
    return lib


def f32tc_library():
    """The loaded ``flash_f32_tc`` library (built at first use), typed."""
    return _typed_library("flash_f32_tc", F32TC_SIGNATURES)


def _on_card(what: str, elems: tuple, rows: tuple = ()) -> bool:
    """False for CPU tensors; for CUDA tensors check what the kernels
    take (one device; ``elems`` of one element type, fp32 or bf16, and
    ``rows`` fp32; any head_dim, padded by `_padded_head_dim`) and return
    True."""
    devices = {x.device for x in elems + rows}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dtypes = {x.dtype for x in elems}
    if len(dtypes) != 1 or elems[0].dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: element types {sorted(map(str, dtypes))}; "
                        "the kernels take one of float32 and bfloat16")
    for x in rows:
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: lse dtype {x.dtype}, expected float32")
    return True


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.flash_error_string(rc).decode()} "
                           f"(cudaError {rc})")


def _dims(q, k):
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match")
    _gqa_rep(q, k)
    return b, tq, tk, h, hkv, d


def flash_gqa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> tuple:
    """``(out (B, Tq, H, D), lse (B, H, Tq))`` of GQA flash attention
    (K9).  CPU tensors take `flash_gqa_fwd_ref`; CUDA tensors launch the
    kernel, counted in ``flash_gqa_fwd.launches``."""
    b, tq, tk, h, hkv, d = _dims(q, k)
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if not _on_card("flash_gqa_fwd", (q, k, v)):
        return flash_gqa_fwd_ref(q, k, v, causal)
    out, lse = _padded_head_dim(launchers(q.dtype, d)[0], (q, k, v), causal,
                                "flash_gqa_fwd")
    flash_gqa_fwd.launches += 1
    return out, lse


def launchers(dtype: torch.dtype, head_dim: int) -> tuple:
    """``(forward, backward)`` launch functions of CUDA calls of ``dtype``
    and ``head_dim`` (padded to `kernel_head_dim` by `_padded_head_dim`):
    up to 128 the tensor-core kernels, fp32 ``flash_f32_tc.cu``'s and
    bf16 ``flash_mha_tc.cu``'s; at 256 ``flash_gqa.cu``'s templates and
    past 256 its head_dim-split arm, in both dtypes."""
    d_p = kernel_head_dim(head_dim)
    if d_p > KERNEL_HEAD_DIMS[-1]:
        return _split_fwd, _split_bwd
    if d_p not in TC_HEAD_DIMS:
        return _launch_fwd, _launch_bwd
    if dtype == torch.float32:
        return _f32tc_fwd, _f32tc_bwd
    return _tc_fwd, _tc_bwd


def _launch_fwd(q, k, v, causal, what, scale=None) -> tuple:
    """``flash_gqa.cu``'s forward template on checked CUDA tensors: K9's
    arm at head_dim 256 and, at the others, the yardstick of
    `core_launchers` in both dtypes: ``(out, lse)``.  ``scale`` defaults
    to `_scale` of the tensors' head_dim."""
    return _core_fwd("flash_fwd_launch", q, k, v, causal, what, scale)


def _split_fwd(q, k, v, causal, what, scale=None) -> tuple:
    """``flash_gqa.cu``'s head_dim-split forward on checked CUDA tensors
    of head_dim a multiple of 128 past 256 (K9 and K11 there):
    ``(out, lse)``."""
    return _core_fwd("flash_split_fwd_launch", q, k, v, causal, what, scale)


def _core_fwd(entry, q, k, v, causal, what, scale) -> tuple:
    b, tq, tk, h, hkv, d = _dims(q, k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out.zero_(), lse.fill_(_NEG_INF)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, tq, tk, h, hkv, d, KERNEL_DTYPES[q.dtype],
            int(causal), _scale(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, what)
    return out, lse


def flash_gqa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool = True) -> tuple:
    """``(dq, dk, dv)`` of GQA flash attention from the forward's inputs,
    output and lse (K10; delta = Σ dout·out is one torch op).  CPU
    tensors take `flash_gqa_bwd_ref`; CUDA tensors launch the dq and the
    dk/dv kernel, counted once per call in ``flash_gqa_bwd.launches``."""
    d = _dims(q, k)[-1]
    if not _on_card("flash_gqa_bwd", (q, k, v, out, dout), (lse,)):
        return flash_gqa_bwd_ref(q, k, v, out, lse, dout, causal)
    grads = _padded_head_dim(launchers(q.dtype, d)[1],
                             (q, k, v, out, lse, dout), causal,
                             "flash_gqa_bwd")
    flash_gqa_bwd.launches += 1
    return grads


def _launch_bwd(q, k, v, out, lse, dout, causal, what, scale=None) -> tuple:
    """``flash_gqa.cu``'s dq and dk/dv templates on checked CUDA tensors:
    K10's arm at head_dim 256 and, at the others, the yardstick of
    `core_launchers` in both dtypes: ``(dq, dk, dv)``."""
    return _core_bwd("flash_bwd_launch", q, k, v, out, lse, dout, causal,
                     what, scale)


def _split_bwd(q, k, v, out, lse, dout, causal, what, scale=None) -> tuple:
    """``flash_gqa.cu``'s head_dim-split dq and dk/dv kernels on checked
    CUDA tensors of head_dim a multiple of 128 past 256 (K10 and K11's
    backward there): ``(dq, dk, dv)``."""
    return _core_bwd("flash_split_bwd_launch", q, k, v, out, lse, dout,
                     causal, what, scale)


def _core_bwd(entry, q, k, v, out, lse, dout, causal, what, scale) -> tuple:
    b, tq, tk, h, hkv, d = _dims(q, k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout, lse = dout.contiguous(), lse.contiguous()
    delta = _delta(out, dout).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if tq == 0 or tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, tq, tk, h, hkv, d, KERNEL_DTYPES[q.dtype],
            int(causal), _scale(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, what)
    return dq, dk, dv


def _tc_args(what: str, *xs: torch.Tensor) -> tuple:
    """Contiguous ``xs`` whose data the kernels' 16-byte copies can read."""
    xs = tuple(x.contiguous() for x in xs)
    for x in xs:
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: a tensor's data is not 16-byte "
                             "aligned, as the kernel's copies need")
    return xs


def _f32tc_fwd(q, k, v, causal, what, scale=None) -> tuple:
    """The 3xTF32 tensor-core forward on checked fp32 CUDA tensors (K9,
    and K11 at rep = 1): ``(out, lse)``."""
    b, tq, tk, h, hkv, d = _dims(q, k)
    q, k, v = _tc_args(what, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or tk == 0:
        return out.zero_(), lse.fill_(_NEG_INF)
    lib = f32tc_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_f32tc_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, tq, tk, h, hkv, d, int(causal),
            _scale(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, what)
    return out, lse


def _f32tc_bwd(q, k, v, out, lse, dout, causal, what, scale=None) -> tuple:
    """The 3xTF32 tensor-core dq and dk/dv kernels on checked fp32 CUDA
    tensors (K10, and K11's backward at rep = 1): ``(dq, dk, dv)``."""
    b, tq, tk, h, hkv, d = _dims(q, k)
    q, k, v, dout, lse, delta = _tc_args(what, q, k, v, dout, lse,
                                         _delta(out, dout))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if tq == 0 or tk == 0 or dq.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # at rep > 1 each query head's dk/dv share lands in scratch and a
    # second kernel sums the rep shares of a kv head in order
    parts = ([torch.empty((b, tk, h, d), dtype=torch.float32,
                          device=q.device) for _ in range(2)]
             if h > hkv else [None, None])
    lib = f32tc_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_f32tc_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *(x.data_ptr() if x is not None else None
                             for x in parts),
            b, tq, tk, h, hkv, d, int(causal),
            _scale(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, what)
    return dq, dk, dv


def tc_library():
    """The loaded ``flash_mha_tc`` library (built at first use), typed."""
    return _typed_library("flash_mha_tc", TC_SIGNATURES)


def _tc_fwd(q, k, v, causal, what, scale=None) -> tuple:
    """The bf16 tensor-core forward on checked bf16 CUDA tensors (K9, and
    K11 at rep = 1): ``(out, lse)``."""
    b, tq, tk, h, hkv, d = _dims(q, k)
    q, k, v = _tc_args(what, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or tk == 0:
        return out.zero_(), lse.fill_(_NEG_INF)
    lib = tc_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_tc_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, tq, tk, h, hkv, d, int(causal),
            _scale(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, what)
    return out, lse


def _tc_bwd(q, k, v, out, lse, dout, causal, what, scale=None) -> tuple:
    """The bf16 tensor-core dq and dk/dv kernels on checked bf16 CUDA
    tensors (K10, and K11's backward at rep = 1): ``(dq, dk, dv)``."""
    b, tq, tk, h, hkv, d = _dims(q, k)
    q, k, v, dout, lse, delta = _tc_args(what, q, k, v, dout, lse,
                                         _delta(out, dout))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if tq == 0 or tk == 0 or dq.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # at rep > 1 each query head's fp32 dk/dv share lands in scratch and a
    # third kernel sums the rep shares of a kv head in order, rounding once
    parts = ([torch.empty((b, tk, h, d), dtype=torch.float32,
                          device=q.device) for _ in range(2)]
             if h > hkv else [None, None])
    lib = tc_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_tc_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *(x.data_ptr() if x is not None else None
                             for x in parts),
            b, tq, tk, h, hkv, d, int(causal),
            _scale(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, what)
    return dq, dk, dv


def core_launchers() -> tuple:
    """``(forward, backward)`` launch functions of ``flash_gqa.cu``'s
    CUDA-core templates, the kernels the tensor-core ones replaced in
    both dtypes.  No path calls them: they are the yardstick
    ``chip_smoke.py`` times the tensor-core kernels against.  They take
    checked CUDA tensors and a label: ``fwd(q, k, v, causal, what)``,
    ``bwd(q, k, v, out, lse, dout, causal, what)``."""
    return _launch_fwd, _launch_bwd


flash_gqa_fwd.launches = 0
flash_gqa_bwd.launches = 0


class _FlashGQA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, bwd):
        out, lse = flash_gqa_fwd(q, k, v, causal)
        ctx.cfg = (causal, bwd)
        if bwd == "pallas":
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, bwd = ctx.cfg
        if bwd == "pallas":
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_gqa_bwd(q, k, v, out, lse, g, causal)
            return dq, dk, dv, None, None
        from .attention import _chunked_attention

        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = _chunked_attention(q, k, v, causal, 0, 0)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, bwd: str = "chunked") -> torch.Tensor:
    """Flash attention with GQA-native unexpanded K/V: q (B, Tq, H, D),
    k/v (B, Tk, H_kv, D), H_kv | H; returns (B, Tq, H, D).  The forward
    is K9; ``bwd`` picks the gradient: "pallas" (K10 against the saved
    lse) or "chunked" (the online-softmax scan's autograd)."""
    _gqa_rep(q, k)
    if bwd not in ("chunked", "pallas"):
        raise ValueError(f"unknown bwd {bwd!r}; 'chunked' or 'pallas'")
    return _FlashGQA.apply(q, k, v, causal, bwd)
