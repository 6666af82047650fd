"""MHA flash attention (K11) and its plain version.

Port of `cpd_tpu/ops/attention.py:116` `_flash_attention`, which runs the
stock Pallas TPU kernel `jax.experimental.pallas.ops.tpu.flash_attention`
(resolved by `cpd_tpu/compat.py:79`) with its own backward, on
(B, T, H, D) q, k, v of one head count, ``sm_scale = 1 / sqrt(D)``:

* forward: s = q·kᵀ in fp32, ``s *= sm_scale``, the causal mask added as
  ``MASK_VALUE`` (−0.7·FLT_MAX), the online softmax (running max m and
  sum l), p rounded to v's dtype before p·v (fp32 accumulation), the
  output rounded to q's dtype once;
* backward: di = Σ o·do in fp32, p = exp(s − lse), dv = pᵀ·do,
  dp = do·vᵀ, ds = (dp − di)·p·sm_scale, dk = dsᵀ·q, dq = ds·k, with p
  and ds rounded to the input dtype before their products and each
  gradient rounded once.

The stock kernel saves l and m for its backward and forms exp(s − m)/l;
the port saves the log-sum-exp lse = m + log l (B, H, Tq) fp32, the same
p to fp32 round-off.  In fp32 every rounding is the identity.

* `flash_mha_fwd_ref` / `flash_mha_bwd_ref` — the plain versions: the
  recipe over the whole score matrix in torch ops, with the same
  roundings;
* `flash_mha_fwd` / `flash_mha_bwd` (K11) — the wrappers.  CPU tensors
  take the plain versions; CUDA tensors launch hand-written kernels
  (head_dim 32, 64 or 128) or raise: bf16 the tensor-core kernels of
  ``csrc/flash_mha_tc.cu`` (`mma.sync` bf16 tiles, fp32 accumulators),
  fp32 the 3xTF32 tensor-core kernels of ``csrc/flash_f32_tc.cu``, both
  at rep = 1, as K9/K10 (`ops.flash_gqa`) launch them (`launchers`).
  ``flash_mha_fwd.launches`` counts forward launches,
  ``flash_mha_bwd.launches`` backward calls (each launches a dq and a
  dk/dv kernel);
* `flash_mha(q, k, v, causal)` — the differentiable function: saves
  (q, k, v, out, lse) and always runs K11's own backward, as the stock
  kernel brings its own VJP.

The wrappers keep the stock kernel's contract at its default 128-wide
blocks on every device and raise `ValueError` in its words: Tq >= 128,
Tk a multiple of 128, head_dim <= 128 or a multiple of 128, and for the
backward Tq a multiple of 128.  There every row sees key 0, so no row is
fully masked.
"""

from __future__ import annotations

import numpy as np
import torch

from .flash_gqa import (TC_SIGNATURES, _f32tc_bwd, _f32tc_fwd, _on_card,
                        _rounded, _scale, _tc_bwd, _tc_fwd, tc_library)

__all__ = ["flash_mha", "flash_mha_fwd", "flash_mha_bwd",
           "flash_mha_fwd_ref", "flash_mha_bwd_ref", "launchers",
           "tc_library", "MASK_VALUE", "BLOCK", "TC_SIGNATURES"]

# the stock kernel's DEFAULT_MASK_VALUE and default block sizes
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
BLOCK = 128


def _verify_block(block_name: str, dim_name: str, dim: int,
                  should_divide: bool = True) -> None:
    """The stock kernel's ``_verify_block`` at a block of ``BLOCK``."""
    if BLOCK > dim:
        raise ValueError(f"{block_name}={BLOCK} should be smaller or equal "
                         f"to {dim_name}={dim}")
    if should_divide and dim % BLOCK != 0:
        raise ValueError(f"{dim_name}={dim} should be divisible by "
                         f"{block_name}={BLOCK}")


def _check_contract(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    backward: bool = False) -> None:
    """What the stock kernel accepts, in its words and order."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, T, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    (b, tq, h, d), (bk, tk, hk, dk) = q.shape, k.shape
    if not b == bk == v.shape[0]:
        raise ValueError(f"Batch size mismatch: got {b}, {bk} and "
                         f"{v.shape[0]} (for q, k, v respectively)")
    if not h == hk == v.shape[2]:
        raise ValueError(f"Head count mismatch: got {h}, {hk}, "
                         f"{v.shape[2]} (for q, k, v respectively)")
    if d != dk:
        raise ValueError(f"Model dimension mismatch: got {d} and {dk} (for "
                         "q and k respectively)")
    if d != v.shape[3] or tk != v.shape[1]:
        raise ValueError(f"v {tuple(v.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if backward:
        _verify_block("block_q_major_dkv", "q_seq_len", tq)
    _verify_block("block_q", "q_seq_len", tq, should_divide=False)
    _verify_block("block_k_major", "kv_seq_len", tk)
    if d > BLOCK and d % BLOCK:
        raise ValueError(f"head_dim={d} should be a multiple of {BLOCK} if "
                         "larger")


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """(B, H, Tq, Tk) fp32 ``q·kᵀ * sm_scale`` plus the additive causal
    mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(
        q.shape[-1])
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s + torch.where(ki <= qi, 0.0, MASK_VALUE)
    return s


def flash_mha_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> tuple:
    """Plain version of K11's forward: ``(out (B, Tq, H, D) in q's dtype,
    lse (B, H, Tq) fp32)``."""
    s = _logits(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", _rounded(p, v.dtype),
                       v.float()) / l.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, causal: bool = True) -> tuple:
    """Plain version of K11's backward: ``(dq, dk, dv)`` in the inputs'
    shapes and dtypes."""
    p = torch.exp(_logits(q, k, causal) - lse[..., None])
    do = dout.float()
    di = (out.float() * do).sum(-1).permute(0, 2, 1)        # (B, H, Tq)
    dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, dout.dtype), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = (dp - di[..., None]) * p * _scale(q.shape[-1])
    dk = torch.einsum("bhqk,bqhd->bkhd", _rounded(ds, dout.dtype),
                      q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", _rounded(ds, k.dtype), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def launchers(dtype: torch.dtype) -> tuple:
    """``(forward, backward)`` launch functions of a CUDA element type:
    bf16 on the tensor-core kernels of ``flash_mha_tc.cu``, fp32 on the
    3xTF32 tensor-core kernels of ``flash_f32_tc.cu``, both K9/K10's
    kernels at rep = 1 (`ops.flash_gqa`)."""
    if dtype == torch.bfloat16:
        return _tc_fwd, _tc_bwd
    return _f32tc_fwd, _f32tc_bwd


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> tuple:
    """``(out, lse)`` of MHA flash attention (K11).  CPU tensors take
    `flash_mha_fwd_ref`; CUDA tensors launch the kernel of their element
    type (`launchers`), counted in ``flash_mha_fwd.launches``."""
    _check_contract(q, k, v)
    if not _on_card("flash_mha_fwd", (q, k, v)):
        return flash_mha_fwd_ref(q, k, v, causal)
    res = launchers(q.dtype)[0](q, k, v, causal, "flash_mha_fwd")
    flash_mha_fwd.launches += 1
    return res


def flash_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool = True) -> tuple:
    """``(dq, dk, dv)`` of MHA flash attention from the forward's inputs,
    output and lse (K11's backward).  CPU tensors take
    `flash_mha_bwd_ref`; CUDA tensors launch the dq and the dk/dv kernel
    of their element type, counted once per call in
    ``flash_mha_bwd.launches``."""
    _check_contract(q, k, v, backward=True)
    if not _on_card("flash_mha_bwd", (q, k, v, out, dout), (lse,)):
        return flash_mha_bwd_ref(q, k, v, out, lse, dout, causal)
    res = launchers(q.dtype)[1](q, k, v, out, lse, dout, causal,
                                "flash_mha_bwd")
    flash_mha_bwd.launches += 1
    return res


flash_mha_fwd.launches = 0
flash_mha_bwd.launches = 0


class _FlashMHA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_mha_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, out, lse, g.to(out.dtype),
                                   ctx.causal)
        return dq, dk, dv, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """MHA flash attention on (B, T, H, D) q, k, v of one head count:
    (B, Tq, H, D) in q's dtype, forward and backward through K11."""
    return _FlashMHA.apply(q, k, v, causal)
