"""Decoder-only transformer LM (port of `cpd_tpu/models/transformer.py`,
single device, full-sequence forward).

The parameters keep the flax layout and names, so a flax param tree maps
onto this module one leaf to one tensor (`interop.load_jax_params`):
Dense kernels are (in, out) and applied as ``h @ kernel``; the fused MHA
projection ``wqkv`` and the GQA ``wq``/``wkv`` pair are head-major;
LayerNorm has ``scale``/``bias`` and the fast variance E[x²] − E[x]²
with eps 1e-6; GELU is the tanh approximation (flax ``nn.gelu``); the
head is tied to the embedding (``x @ embedding.T``).  The block math
started as a copy of `cpd_tpu/interop/torch_lm.py`'s torch mirror.

The full-sequence forward is causal self-attention through
`ops.attention.grouped_query_attention` with the model's ``attn_impl``
("xla", "chunked", or "flash": the K9/K10 kernels for GQA, K11 for MHA)
and ``flash_bwd``.  With ``(ffn_exp, ffn_man) != (8, 23)`` the MLP pair
``wi``/``wo_mlp`` are `QuantDense` layers: their forward and both
backward GEMMs run with the eXmY accumulator (``ffn_mode`` "faithful",
the K8 kernel, or "fast"); the parameter tree does not change.

``dtype`` is the compute dtype over fp32 parameters, as flax's ``dtype``
over ``param_dtype``: at bf16 the embedding rows are gathered and cast,
LayerNorm takes fp32 statistics and emits bf16, Dense casts its input and
kernel and gives a bf16 product, RoPE computes in fp32 and casts back,
GELU and the residual adds run in bf16, `QuantDense` computes in fp32 and
the MLP's output is cast to the residual's dtype, and the tied head is a
bf16 product cast to fp32 logits.  ``remat=True`` recomputes each block's
forward in the backward pass (`torch.utils.checkpoint`, as
``nn.remat(Block)``): the same gradients, with the block's activations
not kept.  Dropout and scanned layers are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import grouped_query_attention
from ..quant.quant_module import QuantDense

__all__ = ["TransformerLM", "transformer_lm", "layer_norm", "rope", "gelu"]

LN_EPS = 1e-6          # flax nn.LayerNorm default


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """flax nn.LayerNorm: fast variance (E[x²] − E[x]², clamped at 0),
    eps 1e-6, learned scale and bias."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    mean2 = (x * x).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (the tanh approximation) as its program runs it:
    op by op in x's dtype, the constants rounded to it, so a bf16 input
    rounds after every op as XLA's bf16 program does."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype, device=x.device)
    a = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on (B, T, H, D), half-split layout, with (B, T)
    per-row positions (serving slots each sit at their own position).
    The frequency table is computed in fp32 as the JAX version does."""
    d = x.shape[-1]
    half = d // 2
    log_base = torch.log(torch.tensor(10000.0, device=x.device))
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device) * (log_base / half))
    angles = positions.to(torch.float32)[..., None] * freqs   # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


class LayerNorm(nn.Module):
    """flax LayerNorm parameters (``scale``, ``bias``) with the fast
    variance of `layer_norm`, fp32 statistics, ``dtype`` out."""

    def __init__(self, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias).to(self.dtype)


class Dense(nn.Module):
    """Bias-free flax Dense: ``kernel`` is (in, out), applied as h @ W
    with both cast to ``dtype``."""

    def __init__(self, d_in: int, d_out: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))

    def forward(self, h):
        return h.to(self.dtype) @ self.kernel.to(self.dtype)


class Embed(nn.Module):
    """flax Embed: ``embedding`` (vocab, d), rows cast to ``dtype``;
    `attend` is the tied head, a ``dtype`` product."""

    def __init__(self, vocab: int, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab, d, device=device))

    def forward(self, tokens):
        return self.embedding[tokens].to(self.dtype)

    def attend(self, x):
        return x.to(self.dtype) @ self.embedding.to(self.dtype).T


class Block(nn.Module):
    """One pre-LN decoder block (attention + GELU MLP)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: Optional[int],
                 d_ff: int, device=None, *, attn_impl: str = "xla",
                 flash_bwd: str = "chunked", ffn_exp: int = 8,
                 ffn_man: int = 23, ffn_mode: str = "faithful",
                 dtype=torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.head_dim = d_model // n_heads
        self.attn_impl = attn_impl
        self.flash_bwd = flash_bwd
        self.ln1 = LayerNorm(d_model, device, dtype)
        self.ln2 = LayerNorm(d_model, device, dtype)
        if n_kv_heads is None:
            self.wqkv = Dense(d_model, 3 * d_model, device, dtype)
        else:
            self.wq = Dense(d_model, d_model, device, dtype)
            self.wkv = Dense(d_model, 2 * n_kv_heads * self.head_dim, device,
                             dtype)
        self.wo = Dense(d_model, d_model, device, dtype)
        if (ffn_exp, ffn_man) != (8, 23):
            kw = dict(exp=ffn_exp, man=ffn_man, mode=ffn_mode, device=device)
            self.wi = QuantDense(d_model, d_ff, **kw)
            self.wo_mlp = QuantDense(d_ff, d_model, **kw)
        else:
            self.wi = Dense(d_model, d_ff, device, dtype)
            self.wo_mlp = Dense(d_ff, d_model, device, dtype)

    def qkv(self, h: torch.Tensor) -> tuple:
        """Head-major projections: q (B, T, H, D), k/v (B, T, H_kv, D)."""
        b, t, _ = h.shape
        hd = self.head_dim
        if self.n_kv_heads is None:
            qkv = self.wqkv(h).reshape(b, t, self.n_heads, 3, hd)
            return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        q = self.wq(h).reshape(b, t, self.n_heads, hd)
        kv = self.wkv(h).reshape(b, t, self.n_kv_heads, 2, hd)
        return q, kv[..., 0, :], kv[..., 1, :]

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.wi(self.ln2(x)))
        return x + self.wo_mlp(h).to(x.dtype)

    def forward(self, x, positions):
        """x: (B, T, d_model); positions: (B, T) RoPE positions — causal
        attention over the sequence itself."""
        q, k, v = self.qkv(self.ln1(x))
        q = rope(q, positions)
        k = rope(k, positions)
        b, t, h, d = q.shape
        attn = grouped_query_attention(q, k, v, causal=True,
                                       impl=self.attn_impl,
                                       flash_bwd=self.flash_bwd)
        x = x + self.wo(attn.reshape(b, t, h * d))
        return self.mlp(x)


class TransformerLM(nn.Module):
    """Decoder-only LM: (B, T) int64 tokens -> (B, T, vocab) fp32 logits.

    Parameters are fp32, created on ``device`` (``cuda`` unless the
    caller asks for ``cpu``) and left uninitialized until `init_weights`
    or `interop.load_jax_params` fills them; ``dtype`` (fp32 or bf16) is
    the compute dtype."""

    def __init__(self, vocab_size: int = 32000, d_model: int = 512,
                 n_layers: int = 4, n_heads: int = 8,
                 n_kv_heads: Optional[int] = None, d_ff: int = 2048,
                 device="cuda", *, attn_impl: str = "xla",
                 flash_bwd: str = "chunked", ffn_exp: int = 8,
                 ffn_man: int = 23, ffn_mode: str = "faithful",
                 dropout_rate: float = 0.0, remat: bool = False,
                 scan_layers: bool = False, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} % n_heads {n_heads} != 0")
        if n_kv_heads is not None and n_heads % n_kv_heads:
            raise ValueError(f"n_heads {n_heads} must be a multiple of "
                             f"n_kv_heads {n_kv_heads}")
        if attn_impl not in ("xla", "flash", "chunked"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}; expected "
                             "'xla', 'flash' or 'chunked'")
        if flash_bwd not in ("chunked", "pallas"):
            raise ValueError(f"unknown flash_bwd {flash_bwd!r}; expected "
                             "'chunked' or 'pallas'")
        if ffn_mode not in ("faithful", "fast"):
            raise ValueError(f"unknown ffn_mode {ffn_mode!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: the compute dtype is "
                             "torch.float32 or torch.bfloat16")
        for name, value in (("dropout_rate", dropout_rate),
                            ("scan_layers", scan_layers)):
            if value:
                raise NotImplementedError(
                    f"{name}: not yet ported to cpd_tpu_torch (ROADMAP "
                    "Queue A, A8)")
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.d_ff = d_ff
        self.remat = remat
        self.embed = Embed(vocab_size, d_model, dev, dtype)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, n_kv_heads, d_ff, dev,
                  attn_impl=attn_impl, flash_bwd=flash_bwd, ffn_exp=ffn_exp,
                  ffn_man=ffn_man, ffn_mode=ffn_mode, dtype=dtype)
            for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model, dev, dtype)

    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights from ``generator`` (flax's default scales:
        Dense kernels N(0, 1/fan_in), embedding N(0, 1/d_model);
        LayerNorm scale 1 and bias 0)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("kernel"):
                    std = p.shape[0] ** -0.5
                elif name.endswith("embedding"):
                    std = p.shape[1] ** -0.5
                else:
                    p.fill_(1.0 if name.endswith("scale") else 0.0)
                    continue
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * std)
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        pos = torch.arange(t, device=tokens.device).expand(b, t)
        x = self.embed(tokens)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, pos, use_reentrant=False)
            else:
                x = blk(x, pos)
        x = self.ln_f(x)
        return self.embed.attend(x).to(torch.float32)


def transformer_lm(vocab_size: int = 32000, d_model: int = 512,
                   n_layers: int = 4, n_heads: int = 8,
                   d_ff: Optional[int] = None, **kw) -> TransformerLM:
    """The JAX factory's defaults (d_ff = 4 * d_model unless given)."""
    return TransformerLM(vocab_size=vocab_size, d_model=d_model,
                         n_layers=n_layers, n_heads=n_heads,
                         d_ff=d_ff or 4 * d_model, **kw)
