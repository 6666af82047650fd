"""Attention ops (port of `cpd_tpu/ops/attention.py`): on one device,
and sequence-parallel over a mesh's sp view.

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
convention).

Sequence-parallel attention over the sp axis of a mesh
(`parallel.mesh`), each taking one (q, k, v) block per local rank of
the view ``sp`` (``sp.ranks`` their axis indices, rank r holding global
positions ``[r*T_local, (r+1)*T_local)``):

* `ring_attention` — Q stays put and the unexpanded GQA K/V rotate
  W - 1 times around the ring (one ``ring_shift`` of the stacked K/V a
  step), each step folded into the online softmax by `_fold_segment`,
  the JAX recurrence (an XLA einsum there, torch products here);
  causal steps whose keys all lie after the queries are folded too, as
  JAX folds them;
* `ulysses_attention` — one all-to-all from sequence to heads, the
  full-sequence `grouped_query_attention` on each rank's head chunk
  (with ``impl="flash"`` the hand-written K9/K10, or K11 at one query
  head a kv head), and one all-to-all back.

Both are differentiable through the mesh's collectives (a ring shift's
backward is the reverse shift, the all-to-all's its inverse).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["local_attention", "grouped_query_attention",
           "ring_attention", "ulysses_attention"]

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


def _ring_block(t_local: int, impl: str, block: int) -> int:
    """The fold's sub-block of a ring step: T_local itself, or with
    ``impl="chunked"`` the largest divisor of T_local <= ``block``.  A
    degenerate split raises, as the JAX ring's does: a divisor that is
    not ``block`` itself and lies below max(8, block // 16)."""
    if impl not in ("xla", "chunked"):
        raise ValueError(f"unknown ring impl {impl!r}; "
                         "expected 'xla' or 'chunked'")
    if impl != "chunked" or t_local <= block:
        return t_local
    div = max(f for f in range(1, block + 1) if t_local % f == 0)
    if div != block and div < max(8, block // 16):
        raise ValueError(
            f"ring impl='chunked' cannot split T_local={t_local} into "
            f"sub-blocks <= {block}: largest divisor is {div} "
            f"(degenerate).  Pick a per-device sequence length divisible "
            f"by the block (multiples of 128 recommended) or pass an "
            f"explicit block= that divides it")
    return div


def ring_attention(qs, ks, vs, sp, causal: bool = True, impl: str = "xla",
                   block: int = _CHUNK) -> list:
    """Sequence-parallel ring attention over the mesh view ``sp``.

    ``qs``: one (B, T_local, H, D) block per local rank of ``sp``;
    ``ks``/``vs``: (B, T_local, H_kv, D) with H_kv | H, which ride the
    ring unexpanded (one stacked K/V tensor a hop).  Returns the
    (B, T_local, H, D) outputs.  Step s folds the K/V block of rank
    ``(r - s) mod W`` at its global offset; ``impl="chunked"`` folds
    each block in sub-blocks (`_ring_block`, each fold recomputed in the
    backward pass), which bounds the score memory by (T_local, block)."""
    from torch.utils.checkpoint import checkpoint

    w = sp.world
    b, t_local, h, d = qs[0].shape
    hkv = ks[0].shape[2]
    rep = _gqa_rep(qs[0], ks[0])
    sub = _ring_block(t_local, impl, block)
    n_inner = t_local // sub
    scale = _scale(d)
    dev = qs[0].device
    state = []
    for _ in qs:
        o = torch.zeros((b, t_local, h, vs[0].shape[-1]),
                        dtype=torch.float32, device=dev)
        m = torch.full((b, h, t_local), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, t_local), dtype=torch.float32, device=dev)
        state.append((o, m, l))
    qgs = [q.reshape(b, t_local, hkv, rep, d) for q in qs]
    kv = [torch.stack([k.to(q.dtype), v.to(q.dtype)])
          for q, k, v in zip(qs, ks, vs)]
    for s in range(w):
        for i, r in enumerate(sp.ranks):
            o, m, l = state[i]
            k_off = ((r - s) % w) * t_local
            qi = r * t_local + torch.arange(t_local, device=dev)[:, None]
            for j in range(n_inner):
                seg = slice(j * sub, (j + 1) * sub)
                valid = None
                if causal:
                    ki = k_off + j * sub + torch.arange(sub,
                                                        device=dev)[None, :]
                    valid = qi >= ki
                args = (o, m, l, qgs[i], kv[i][0][:, seg], kv[i][1][:, seg],
                        valid, scale)
                if n_inner > 1 and torch.is_grad_enabled():
                    o, m, l = checkpoint(_fold_segment, *args,
                                         use_reentrant=False)
                else:
                    o, m, l = _fold_segment(*args)
            state[i] = (o, m, l)
        if s < w - 1:
            # the last rotation would only restore the placement
            kv = sp.ring_shift(kv)
    return [(o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
             ).to(q.dtype) for (o, _, l), q in zip(state, qs)]


def _seq_to_heads(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, T_local, H, D) -> the (W, B, T_local, H/W, D) stack whose row
    j is head chunk j, sent to rank j."""
    b, t, h, d = x.shape
    return x.reshape(b, t, w, h // w, d).permute(2, 0, 1, 3, 4).contiguous()


def ulysses_attention(qs, ks, vs, sp, causal: bool = True,
                      impl: str = "xla", flash_bwd: str = "chunked") -> list:
    """All-to-all sequence-parallel attention over the mesh view ``sp``.

    ``qs``: one (B, T_local, H, D) block per local rank, H divisible by
    the axis size W; ``ks``/``vs``: (B, T_local, H_kv, D).  One
    all-to-all per tensor moves each rank's head chunk of the whole
    sequence to it ((B, T, H/W, D), contiguous, rank order along T), the
    middle step is `grouped_query_attention` with ``impl``/``flash_bwd``
    on it, and one all-to-all moves the outputs back.  GQA K/V travel
    unexpanded when W | H_kv; otherwise they are expanded by the minimal
    factor e (the smallest divisor of rep with W | H_kv * e), which keeps
    every rank's query heads served by its own kv chunk."""
    w = sp.world
    b, t_local, h, d = qs[0].shape
    rep = _gqa_rep(qs[0], ks[0])
    if h % w:
        raise ValueError(f"ulysses needs q heads {h} divisible by the sp "
                         f"axis size {w}")
    hkv = ks[0].shape[2]
    if hkv % w:
        e = next(f for f in range(1, rep + 1)
                 if rep % f == 0 and (hkv * f) % w == 0)
        ks = [k.repeat_interleave(e, dim=2) for k in ks]
        vs = [v.repeat_interleave(e, dim=2) for v in vs]

    def to_heads(xs):
        out = sp.all_to_all([_seq_to_heads(x, w) for x in xs])
        # row s: rank s's sequence block of this rank's head chunk
        return [y.permute(1, 0, 2, 3, 4).reshape(
            b, w * t_local, y.shape[3], y.shape[4]) for y in out]

    qh, kh, vh = to_heads(qs), to_heads(ks), to_heads(vs)
    outs = [grouped_query_attention(q, k, v, causal=causal, impl=impl,
                                    flash_bwd=flash_bwd)
            for q, k, v in zip(qh, kh, vh)]
    back = sp.all_to_all([
        o.reshape(b, w, t_local, h // w, d).permute(1, 0, 2, 3, 4)
        .contiguous() for o in outs])
    # row s: this rank's sequence block of rank s's head chunk
    return [y.permute(1, 2, 0, 3, 4).reshape(b, t_local, h, d)
            for y in back]
