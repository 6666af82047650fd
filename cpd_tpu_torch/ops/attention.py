"""Single-device attention ops (port of `cpd_tpu/ops/attention.py` at
sequence-parallel size 1).

* `local_attention` — softmax attention on (B, T, H, D) tensors with an
  fp32 softmax, ``impl="xla"`` (one-shot), ``"chunked"`` (the online
  softmax over K/V blocks) or ``"flash"`` (the MHA flash kernel K11,
  `ops.flash_mha`, forward and backward);
* `grouped_query_attention` — GQA on unexpanded (B, T, H_kv, D) K/V:
  the query heads are grouped (H_kv, rep) and contracted against the
  small K/V directly.  ``impl="flash"`` routes GQA (H > H_kv) to the
  flash kernels (`ops.flash_gqa`, K9/K10) and MHA (H == H_kv) to K11;
* `_chunked_attention` — the online-softmax scan, also the gradient of
  the flash path's ``bwd="chunked"``.

Fully masked query rows return zero in every impl (the JAX package's
convention).  Ring and Ulysses attention wait for the sequence-parallel
mesh.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["local_attention", "grouped_query_attention"]

_NEG_INF = -1e30   # masked logit: keeps the softmax NaN-free on a full row
_CHUNK = 512       # K/V block of the chunked scan (the JAX package's)


def _scale(d: int) -> float:
    """1/sqrt(d) in fp32, as ``1 / jnp.sqrt(jnp.float32(d))``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _causal_mask(tq: int, tk: int, q_off: int, k_off: int,
                 device) -> torch.Tensor:
    """(tq, tk) bool: query global position >= key global position."""
    qi = q_off + torch.arange(tq, device=device)[:, None]
    ki = k_off + torch.arange(tk, device=device)[None, :]
    return qi >= ki


def _gqa_rep(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query heads per kv head, validated (1 = MHA)."""
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    return h // hkv


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    k_offset: int = 0, impl: str = "xla") -> torch.Tensor:
    """Softmax attention for (B, T, H, D) tensors on one device: fp32
    logits and softmax, q's dtype out.  Offsets are the tokens' global
    positions.  ``impl="flash"`` runs the MHA flash kernel (K11,
    `ops.flash_mha.flash_mha`) with its contract (Tq >= 128, Tk a
    multiple of 128, zero offsets)."""
    if impl == "flash":
        if q_offset != 0 or k_offset != 0:
            raise ValueError("impl='flash' does not support q/k offsets; "
                             "use the default impl inside ring steps")
        from .flash_mha import flash_mha
        return flash_mha(q, k, v, causal)
    if impl == "chunked":
        return _chunked_attention(q, k, v, causal, q_offset, k_offset)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "expected 'xla', 'flash' or 'chunked'")
    scale = _scale(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, k_offset,
                            q.device)
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).float()
    if mask is not None:
        out = torch.where(mask.any(-1)[None, :, None, None], out, 0.0)
    return out.to(q.dtype)


def _fold_segment(o, m, l, qg, k_cur, v_cur, valid, scale):
    """Merge one K/V segment into the online-softmax accumulator
    (o (B, Tq, H, D), m and l (B, H, Tq)); qg: (B, Tq, H_kv, rep, D)
    grouped queries; valid: (Tq, S) bool or None.  Logits and p·v
    accumulate in fp32 whatever the input dtype (p rounded to v's dtype
    first), as the JAX fold's ``preferred_element_type`` does."""
    b, tq, hkv, rep, d = qg.shape
    h = hkv * rep
    s = k_cur.shape[1]
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          k_cur.float()).reshape(b, h, tq, s) * scale
    if valid is not None:
        logits = torch.where(valid[None, None], logits, _NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    if valid is not None:
        # zero by the mask, not by exp(-1e30 - m): a row masked so far has
        # m_new == -1e30, and exp(0) == 1 would count every masked key
        p = torch.where(valid[None, None], p, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bgrqk,bkgd->bqgrd",
                      p.to(v_cur.dtype).float().reshape(b, hkv, rep, tq, s),
                      v_cur.float()).reshape(b, tq, h, v_cur.shape[-1])
    return o * alpha.transpose(1, 2)[..., None] + pv, m_new, l_new


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, q_offset: int, k_offset: int,
                       block: int = _CHUNK) -> torch.Tensor:
    """Flash-style attention in torch ops: the online softmax over K/V
    blocks of ``block`` keys (clamped to Tk rounded up to 128), GQA-
    native; pad keys are masked by position.  Each block's fold is
    recomputed in the backward pass (`torch.utils.checkpoint`), so the
    gradient keeps the O(Tq·block) score memory, as the JAX scan's
    `jax.checkpoint` does."""
    from torch.utils.checkpoint import checkpoint

    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = _gqa_rep(q, k)
    scale = _scale(d)
    qg = q.reshape(b, tq, hkv, rep, d)
    block = min(block, max(128, -(-tk // 128) * 128))
    n_blocks = -(-tk // block)
    pad = n_blocks * block - tk
    kp = torch.nn.functional.pad(k.to(q.dtype), (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.to(q.dtype), (0, 0, 0, 0, 0, pad))
    qi = q_offset + torch.arange(tq, device=q.device)[:, None]
    o = torch.zeros((b, tq, h, v.shape[-1]), dtype=torch.float32,
                    device=q.device)
    m = torch.full((b, h, tq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    for i in range(n_blocks):
        ki = k_offset + i * block + torch.arange(block,
                                                 device=q.device)[None, :]
        valid = (ki - k_offset) < tk
        if causal:
            valid = valid & (qi >= ki)
        seg = slice(i * block, (i + 1) * block)
        args = (o, m, l, qg, kp[:, seg], vp[:, seg], valid, scale)
        if torch.is_grad_enabled():
            o, m, l = checkpoint(_fold_segment, *args, use_reentrant=False)
        else:
            o, m, l = _fold_segment(*args)
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def grouped_query_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            q_offset: int = 0, impl: str = "xla",
                            flash_bwd: str = "chunked") -> torch.Tensor:
    """GQA softmax attention without materializing the K/V expansion.

    q: (B, Tq, H, D) with H = rep * H_kv; k, v: (B, Tk, H_kv, D); kv head
    g serves query heads [g·rep, (g+1)·rep).  ``impl="flash"`` with
    H > H_kv runs the flash kernels (`ops.flash_gqa.flash_gqa`, backward
    ``flash_bwd``); ``"chunked"`` the online-softmax scan; ``"xla"`` the
    one-shot grouped softmax.  MHA goes to `local_attention`, whose
    ``"flash"`` is K11 with its own backward."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    if impl == "flash" and h != hkv:
        if q_offset != 0:
            raise ValueError("impl='flash' does not support q offsets; "
                             "use the default impl inside ring steps")
        from .flash_gqa import flash_gqa
        return flash_gqa(q, k, v, causal, flash_bwd)
    if impl == "chunked":
        return _chunked_attention(q, k, v, causal, q_offset, 0)
    if h == hkv:
        return local_attention(q, k, v, causal=causal, q_offset=q_offset,
                               impl=impl)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "expected 'xla', 'flash' or 'chunked'")
    rep = _gqa_rep(q, k)
    scale = _scale(d)
    qg = q.reshape(b, tq, hkv, rep, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    mask = None
    if causal:
        mask = _causal_mask(tq, k.shape[1], q_offset, 0, q.device)
        logits = torch.where(mask[None, None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype), v).float()
    if mask is not None:
        out = torch.where(mask.any(-1)[None, :, None, None, None], out, 0.0)
    return out.reshape(b, tq, h, d).to(q.dtype)
