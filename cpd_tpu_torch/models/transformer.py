"""Decoder-only transformer LM (port of `cpd_tpu/models/transformer.py`:
the full-sequence forward on one device and the sequence-parallel
forward; no tp, no KV-cache decode).

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
not kept.  Scanned layers are not ported yet and raise.

``dropout_rate`` in [0, 1) drops the residual branches where the JAX
block does, after the attention projection and after the MLP, in
training only (``model.train()``; identity in eval).  The masks are
flax's, bit for bit: the forward takes the step's key (a `prng` pair),
block i's two ``nn.Dropout`` modules derive theirs as flax's
``make_rng`` does (`dropout_key`: one SHA-1 of the scope path
``("block{i}", "Dropout_{site}")`` and the rng counter 1, folded in),
and the mask is ``uniform(bits) < keep`` over `jax.random.bits`'
stream, applied as ``where(mask, x * (1 / keep), 0)`` (`dropout`: XLA's
form of flax's ``x / keep``).  On the
card the bits are the flat-index arm of the hand-written `sr_bits`
kernel; on the CPU, `quant.prng`.

With ``sp_axis`` the model also runs sequence-parallel: `forward_sp`
takes one (B, T_local) token block per local rank of the mesh's sp view
and runs the ranks' forwards layer by layer together, every attention
layer through `ops.attention.ring_attention` (``sp_mode="ring"``) or
`ops.attention.ulysses_attention` (``"ulysses"``) on the ranks' q, k, v,
with RoPE positions offset by ``sp_index * T_local``.  ``params`` gives
each rank its own parameter tensors (aliases of the weights, so that
autograd keeps one gradient per rank, as each shard_map rank holds its
own copy); they are bound to the modules with
`torch.func.functional_call`.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import (grouped_query_attention, ring_attention,
                             ulysses_attention)
from ..quant.prng import fold_in
from ..quant.quant_module import QuantDense

__all__ = ["TransformerLM", "transformer_lm", "layer_norm", "rope", "gelu",
           "dropout", "dropout_key"]

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


def dropout_key(key: tuple, block: int, site: int) -> tuple:
    """The key flax's ``make_rng("dropout")`` gives the ``site``-th
    ``nn.Dropout`` (0: attention, 1: MLP) of ``block{block}`` under the
    step key ``key``: ``fold_in(key, h)`` with ``h`` the first 4 bytes
    (big-endian) of the SHA-1 of the scope path and the rng counter 1
    (`flax.core.scope._fold_in_static`, with flax's default
    ``flax_fix_rng_separator`` off: the items hashed back to back)."""
    m = hashlib.sha1()
    for x in (f"block{block}", f"Dropout_{site}", 1):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def dropout_mask(key: tuple, x: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's keep mask of ``x``'s shape: ``jax.random.bernoulli(key,
    1 - rate)``, i.e. ``uniform(key) < keep`` in fp32, the uniform built
    from `jax.random.bits`' stream as ``(bits >> 9 | 0x3F800000) - 1``
    (the flat-index bits of `ops.quantize.sr_bits`: the kernel on the
    card, `quant.prng` on the CPU)."""
    from ..ops.quantize import sr_bits

    bits = sr_bits(key, x, flat=True)
    u = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    return (u < 1.0 - rate).reshape(x.shape)


def dropout(x: torch.Tensor, rate: float, key: tuple) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training: ``select(mask, x / keep,
    0)`` with `dropout_mask`'s mask, the division as XLA compiles it: a
    product with the reciprocal of ``keep``, that reciprocal rounded in
    ``x``'s dtype (XLA's simplifier rewrites a division by a constant)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    recip = one / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(dropout_mask(key, x, rate), x * recip,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _direct(mod, *args):
    return mod(*args)


class _Bound:
    """Calls a model's modules with one rank's parameter tensors
    (``params``: {parameter name: tensor}, every parameter of the model),
    through `torch.func.functional_call`."""

    def __init__(self, model: nn.Module, params: dict):
        self.by_module = {}
        for prefix, mod in model.named_modules():
            own = [n for n, _ in mod.named_parameters(recurse=False)]
            if own:
                self.by_module[mod] = {
                    n: params[f"{prefix}.{n}" if prefix else n] for n in own}

    def __call__(self, mod, *args):
        return torch.func.functional_call(mod, self.by_module[mod], args)

    def tensor(self, mod, name: str) -> torch.Tensor:
        return self.by_module[mod][name]


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
    """One pre-LN decoder block (attention + GELU MLP), the ``index``-th
    of the stack (flax's ``block{index}``: its dropout keys hash it)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: Optional[int],
                 d_ff: int, device=None, *, attn_impl: str = "xla",
                 flash_bwd: str = "chunked", ffn_exp: int = 8,
                 ffn_man: int = 23, ffn_mode: str = "faithful",
                 dtype=torch.float32, dropout_rate: float = 0.0,
                 index: int = 0):
        super().__init__()
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.head_dim = d_model // n_heads
        self.attn_impl = attn_impl
        self.flash_bwd = flash_bwd
        self.dropout_rate = dropout_rate
        self.index = index
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

    def qkv(self, h: torch.Tensor, call=_direct) -> tuple:
        """Head-major projections: q (B, T, H, D), k/v (B, T, H_kv, D)."""
        b, t, _ = h.shape
        hd = self.head_dim
        if self.n_kv_heads is None:
            qkv = call(self.wqkv, h).reshape(b, t, self.n_heads, 3, hd)
            return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        q = call(self.wq, h).reshape(b, t, self.n_heads, hd)
        kv = call(self.wkv, h).reshape(b, t, self.n_kv_heads, 2, hd)
        return q, kv[..., 0, :], kv[..., 1, :]

    def _drop(self, x: torch.Tensor, key, site: int) -> torch.Tensor:
        if not self.dropout_rate or not self.training:
            return x
        if key is None:
            raise ValueError("dropout in training needs the step's key "
                             "(flax: rngs={'dropout': key})")
        return dropout(x, self.dropout_rate,
                       dropout_key(key, self.index, site))

    def attention_inputs(self, x, positions, call=_direct) -> tuple:
        """q, k, v of ``x`` with RoPE at ``positions`` applied to q and
        k."""
        q, k, v = self.qkv(call(self.ln1, x), call)
        return rope(q, positions), rope(k, positions), v

    def finish(self, x, attn, call=_direct, key=None):
        """The block after attention: the output projection, its
        dropout, the residual add and the MLP."""
        b, t, h, d = attn.shape
        x = x + self._drop(call(self.wo, attn.reshape(b, t, h * d)), key, 0)
        return self.mlp(x, call, key)

    def mlp(self, x: torch.Tensor, call=_direct, key=None) -> torch.Tensor:
        h = gelu(call(self.wi, call(self.ln2, x)))
        return x + self._drop(call(self.wo_mlp, h).to(x.dtype), key, 1)

    def forward(self, x, positions, key=None):
        """x: (B, T, d_model); positions: (B, T) RoPE positions — causal
        attention over the sequence itself; ``key``: the step's dropout
        key."""
        q, k, v = self.attention_inputs(x, positions)
        attn = grouped_query_attention(q, k, v, causal=True,
                                       impl=self.attn_impl,
                                       flash_bwd=self.flash_bwd)
        return self.finish(x, attn, key=key)


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
                 scan_layers: bool = False, dtype=torch.float32,
                 sp_axis: Optional[str] = None, sp_mode: str = "ring"):
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
        if not 0.0 <= dropout_rate < 1.0:
            # 1.0 would zero every residual branch (flax returns zeros)
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{dropout_rate}")
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_mode {sp_mode!r}; expected "
                             "'ring' or 'ulysses'")
        if attn_impl == "flash" and sp_axis and sp_mode == "ring":
            raise ValueError("attn_impl='flash' does not compose with ring "
                             "sequence parallelism (the ring's online-"
                             "softmax accumulation is its own schedule); "
                             "use sp_mode='ulysses'")
        if scan_layers:
            raise NotImplementedError(
                "scan_layers: not yet ported to cpd_tpu_torch (ROADMAP "
                "Queue A, row 1: it goes with tp)")
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.d_ff = d_ff
        self.remat = remat
        self.dropout_rate = dropout_rate
        self.attn_impl = attn_impl
        self.flash_bwd = flash_bwd
        self.sp_axis = sp_axis
        self.sp_mode = sp_mode
        self.embed = Embed(vocab_size, d_model, dev, dtype)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, n_kv_heads, d_ff, dev,
                  attn_impl=attn_impl, flash_bwd=flash_bwd, ffn_exp=ffn_exp,
                  ffn_man=ffn_man, ffn_mode=ffn_mode, dtype=dtype,
                  dropout_rate=dropout_rate, index=i)
            for i in range(n_layers))
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

    def forward(self, tokens: torch.Tensor, key=None) -> torch.Tensor:
        """The full sequence on one device; ``key``: the step's dropout
        key (needed in training with ``dropout_rate > 0``)."""
        b, t = tokens.shape
        pos = torch.arange(t, device=tokens.device).expand(b, t)
        x = self.embed(tokens)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, pos, key, use_reentrant=False)
            else:
                x = blk(x, pos, key)
        x = self.ln_f(x)
        return self.embed.attend(x).to(torch.float32)

    def _sp_layer(self, blk, sp, calls, pos, keys, *xs) -> list:
        qkv = [blk.attention_inputs(x, p, c)
               for x, p, c in zip(xs, pos, calls)]
        qs, ks, vs = zip(*qkv)
        if self.sp_mode == "ulysses":
            attn = ulysses_attention(qs, ks, vs, sp, causal=True,
                                     impl=self.attn_impl,
                                     flash_bwd=self.flash_bwd)
        else:
            attn = ring_attention(qs, ks, vs, sp, causal=True,
                                  impl=("chunked" if self.attn_impl ==
                                        "chunked" else "xla"))
        return [blk.finish(x, a, c, k)
                for x, a, c, k in zip(xs, attn, calls, keys)]

    def forward_sp(self, tokens, sp, params=None, keys=None) -> list:
        """The sequence-parallel forward (module docstring): ``tokens``
        one (B, T_local) block per local rank of the mesh view ``sp``
        (``sp.ranks`` their sp indices), ``params`` None (the module's
        own weights: one rank, a `ProcessMesh`) or one {name: tensor}
        dict per rank, ``keys`` each rank's dropout key.  Returns each
        rank's (B, T_local, vocab) fp32 logits."""
        if self.sp_axis is None:
            raise ValueError("forward_sp needs a model built with sp_axis")
        n = len(tokens)
        b, t = tokens[0].shape
        dev = tokens[0].device
        calls = ([_direct] * n if params is None
                 else [_Bound(self, p) for p in params])
        keys = [None] * n if keys is None else list(keys)
        pos = [(r * t + torch.arange(t, device=dev)).expand(b, t)
               for r in sp.ranks]
        xs = [c(self.embed, tk) for c, tk in zip(calls, tokens)]
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                xs = checkpoint(self._sp_layer, blk, sp, calls, pos, keys,
                                *xs, use_reentrant=False)
            else:
                xs = self._sp_layer(blk, sp, calls, pos, keys, *xs)
        out = []
        for c, x in zip(calls, xs):
            x = c(self.ln_f, x).to(self.embed.dtype)
            emb = (self.embed.embedding if c is _direct
                   else c.tensor(self.embed, "embedding"))
            out.append((x @ emb.to(self.embed.dtype).T).to(torch.float32))
        return out


def transformer_lm(vocab_size: int = 32000, d_model: int = 512,
                   n_layers: int = 4, n_heads: int = 8,
                   d_ff: Optional[int] = None, **kw) -> TransformerLM:
    """The JAX factory's defaults (d_ff = 4 * d_model unless given)."""
    return TransformerLM(vocab_size=vocab_size, d_model=d_model,
                         n_layers=n_layers, n_heads=n_heads,
                         d_ff=d_ff or 4 * d_model, **kw)
