"""Decoder-only transformer LM (port of `cpd_tpu/models/transformer.py`:
the full-sequence forward on one device and the forward over one dp
index's sequence- and tensor-parallel ranks, unrolled or scanned
layers; no KV-cache decode).

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
not kept.

``dropout_rate`` in [0, 1) drops the residual branches where the JAX
block does, after the attention projection and after the MLP (after
their tp sums), in training only (``model.train()``; identity in eval).
The masks are flax's, bit for bit: the forward takes the step's key (a
`prng` pair), block i's two ``nn.Dropout`` modules derive theirs as
flax's ``make_rng`` does (`dropout_key`: one SHA-1 of the scope path
``("block{i}", "Dropout_{site}")`` and the rng counter 1, folded in;
under scanned layers `scan_dropout_key`), and the mask is
``uniform(bits) < keep`` over `jax.random.bits`' stream, applied as
``where(mask, x * (1 / keep), 0)`` (`dropout`: XLA's form of flax's
``x / keep``).  On the card the bits are the flat-index arm of the
hand-written `sr_bits` kernel; on the CPU, `quant.prng`.

With ``sp_axis`` and/or ``tp_axis`` the model runs over a group of
ranks: `forward_sp` takes one (B, T_local) token block per local rank
of one dp index (every rank's sp view and tp view over the same
members) and runs the ranks' forwards layer by layer together, every
attention layer through `ops.attention.ring_attention`
(``sp_mode="ring"``) or `ops.attention.ulysses_attention`
(``"ulysses"``) on the ranks' q, k, v, with RoPE positions offset by
``sp_index * T_local`` (without ``sp_axis``, each rank's own
`grouped_query_attention`).  ``params`` gives each rank its own
parameter tensors (aliases of the weights, so that autograd keeps one
gradient per rank, as each shard_map rank holds its own copy); they are
bound to the modules with `torch.func.functional_call`.

Tensor parallelism is Megatron's, as the JAX block has it
(`megatron_shard_kind`, `lm_param_specs`): the ``wqkv``/``wq``/``wkv``/
``wi`` kernels are column-sharded over tp (their out dim), the ``wo``/
``wo_mlp`` kernels row-sharded (their in dim), everything else — the
embedding, the LayerNorms — replicated.  The projections are head-major,
so a column slice keeps whole heads, and a block reads its local head
counts from its kernels' shapes.  After each row-sharded projection the
tp ranks' partial outputs are summed by the tp view's ``psum`` (the
rank-order sum forward, the rank-order sum of the cotangents backward,
as shard_map transposes JAX's ``psum``): the attention projection in
the compute dtype, the MLP's output in fp32 before its cast (QuantDense's
per-shard eXmY results are summed in fp32).  A model built with
``tp_size`` > 1 holds only its shard (local widths, ``// tp_size``), as a
shard_map device does: one rank a process (`parallel.mesh.ProcessMesh`),
its weights the full model's shard (`load_shard`).  On a
`parallel.mesh.LocalMesh` one model at ``tp_size`` 1 holds the full
weights and each tp rank computes with its own slice of them
(`rank_params`).

``scan_layers=True`` is JAX's ``nn.scan`` over the block: one module
``blocks`` whose leaves carry a leading (n_layers,) axis under the
block's names (flax's scanned layout), layer i computed from ``leaf[i]``
(bitwise the unrolled stack on the same weights), ``remat`` per layer,
and layer i's dropout keys from the i-th of a split of the step key
(`scan_dropout_key`).  The shard rules are rank-aware: a stacked kernel
is sharded on its last or second-to-last dim.
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
from ..quant.prng import fold_in, split
from ..quant.quant_module import QuantDense

__all__ = ["TransformerLM", "transformer_lm", "layer_norm", "rope", "gelu",
           "dropout", "dropout_key", "scan_dropout_key",
           "megatron_shard_kind", "lm_param_specs", "shard_dim",
           "shard_param", "rank_params"]

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


def _fold_in_static(key: tuple, items: tuple) -> tuple:
    """`flax.core.scope._fold_in_static`: ``fold_in(key, h)`` with ``h``
    the first 4 bytes (big-endian) of the SHA-1 of ``items`` (strings
    and ints hashed back to back, flax's default
    ``flax_fix_rng_separator`` off)."""
    m = hashlib.sha1()
    for x in items:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def dropout_key(key: tuple, block: int, site: int) -> tuple:
    """The key flax's ``make_rng("dropout")`` gives the ``site``-th
    ``nn.Dropout`` (0: attention, 1: MLP) of ``block{block}`` under the
    step key ``key``: the scope path and the rng counter 1 folded in
    (`_fold_in_static`)."""
    return _fold_in_static(key, (f"block{block}", f"Dropout_{site}", 1))


# the rng counter of a Dropout inside flax's jitted nn.scan body: flax
# traces the body twice (a shape pass, then the scan), and the scope's
# counter is not reset between the two traces
SCAN_RNG_COUNT = 2


def scan_dropout_key(key: tuple, layer: int, n_layers: int,
                     site: int) -> tuple:
    """The key of the ``site``-th ``nn.Dropout`` of layer ``layer`` under
    flax's ``nn.scan(Block, split_rngs={"dropout": True}, length=
    n_layers, name="blocks")``: `flax.core.lift.scan` splits the step
    key into ``n_layers`` (``jax.random.split``), and layer i's scope
    folds its path ``("blocks", "Dropout_{site}")`` and the rng counter
    (`SCAN_RNG_COUNT`) into the i-th."""
    return _fold_in_static(split(key, n_layers)[layer],
                           ("blocks", f"Dropout_{site}", SCAN_RNG_COUNT))


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


def megatron_shard_kind(names) -> Optional[str]:
    """The Megatron rule for a parameter path (its names, e.g.
    ``"blocks.0.wq.kernel".split(".")``): ``"col"`` (out dim tp-sharded:
    the ``wqkv``/``wq``/``wkv``/``wi`` kernels), ``"row"`` (in dim
    tp-sharded: the ``wo``/``wo_mlp`` kernels) or None (replicated).  The
    layer names match exactly, as the JAX rule's do."""
    if len(names) >= 2 and names[-1] == "kernel":
        if names[-2] in ("wqkv", "wq", "wkv", "wi"):
            return "col"
        if names[-2] in ("wo", "wo_mlp"):
            return "row"
    return None


def shard_dim(kind: Optional[str], ndim: int) -> Optional[int]:
    """The dim a leaf of ``ndim`` dims is sharded on: the last for
    ``"col"``, the second-to-last for ``"row"`` (rank-aware: a scanned
    (n_layers, in, out) kernel keeps its layer axis whole), None for a
    replicated leaf."""
    if kind == "col":
        return ndim - 1
    if kind == "row":
        return ndim - 2
    return None


def lm_param_specs(named) -> dict:
    """``{name: (kind, dim)}`` of the Megatron rules for (name, leaf)
    pairs or a {name: leaf} dict (the port's parameter names or a flat
    flax tree's dotted keys; the JAX ``lm_param_specs``): `megatron_
    shard_kind` and `shard_dim`, ``(None, None)`` for a replicated
    leaf."""
    items = named.items() if hasattr(named, "items") else named
    out = {}
    for name, leaf in items:
        kind = megatron_shard_kind(name.split("."))
        out[name] = (kind, shard_dim(kind, len(leaf.shape)))
    return out


def shard_param(leaf, kind: Optional[str], tp_index: int, tp: int):
    """tp rank ``tp_index``'s block of ``leaf`` (a tensor or a numpy
    array) under ``kind``: the ``tp_index``-th of ``tp`` equal slices of
    its sharded dim (the local block shard_map hands that rank), or the
    leaf itself where it is replicated."""
    dim = shard_dim(kind, len(leaf.shape))
    if dim is None or tp == 1:
        return leaf
    n = leaf.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of a {kind} leaf {tuple(leaf.shape)} "
                         f"does not split into tp={tp} shards")
    w = n // tp
    idx = [slice(None)] * len(leaf.shape)
    idx[dim] = slice(tp_index * w, (tp_index + 1) * w)
    return leaf[tuple(idx)]


def rank_params(model: nn.Module, tp_index: int, tp: int,
                grad: bool = False) -> dict:
    """tp rank ``tp_index``'s parameters out of ``model``'s full weights:
    {name: tensor}, a sharded leaf its contiguous slice (`shard_param`),
    a replicated leaf the weight itself, all detached; with ``grad`` each
    one a leaf that requires grad (the rank's own aliases, `train.lm`)."""
    specs = lm_param_specs(model.named_parameters())
    return {n: shard_param(p.detach(), specs[n][0], tp_index, tp)
            .contiguous().requires_grad_(grad)
            for n, p in model.named_parameters()}


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

    def layer(self, blocks: nn.Module, i: int) -> "_Bound":
        """The same binding with the scanned ``blocks``' stacked leaves
        replaced by their layer ``i`` (``leaf[i]``)."""
        out = object.__new__(_Bound)
        out.by_module = dict(self.by_module)
        for mod in blocks.modules():
            if mod in out.by_module:
                out.by_module[mod] = {n: t[i] for n, t in
                                      out.by_module[mod].items()}
        return out


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
    of the stack (flax's ``block{index}``), at ``tp_size`` shards' local
    widths; with ``stack`` = n_layers every leaf carries a leading
    (n_layers,) axis (the scanned layout, layer i at ``leaf[i]``).  The
    model runs its steps over a group of ranks (`TransformerLM._layer`)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: Optional[int],
                 d_ff: int, device=None, *, attn_impl: str = "xla",
                 flash_bwd: str = "chunked", ffn_exp: int = 8,
                 ffn_man: int = 23, ffn_mode: str = "faithful",
                 dtype=torch.float32, dropout_rate: float = 0.0,
                 index: int = 0, tp_size: int = 1,
                 stack: Optional[int] = None):
        super().__init__()
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.head_dim = d_model // n_heads
        self.attn_impl = attn_impl
        self.flash_bwd = flash_bwd
        self.dropout_rate = dropout_rate
        self.index = index
        t = tp_size
        self.ln1 = LayerNorm(d_model, device, dtype)
        self.ln2 = LayerNorm(d_model, device, dtype)
        if n_kv_heads is None:
            self.wqkv = Dense(d_model, 3 * d_model // t, device, dtype)
        else:
            self.wq = Dense(d_model, d_model // t, device, dtype)
            self.wkv = Dense(d_model, 2 * n_kv_heads * self.head_dim // t,
                             device, dtype)
        self.wo = Dense(d_model // t, d_model, device, dtype)
        if (ffn_exp, ffn_man) != (8, 23):
            kw = dict(exp=ffn_exp, man=ffn_man, mode=ffn_mode, device=device)
            self.wi = QuantDense(d_model, d_ff // t, **kw)
            self.wo_mlp = QuantDense(d_ff // t, d_model, **kw)
        else:
            self.wi = Dense(d_model, d_ff // t, device, dtype)
            self.wo_mlp = Dense(d_ff // t, d_model, device, dtype)
        if stack is not None:
            for mod in self.modules():
                for n, p in list(mod.named_parameters(recurse=False)):
                    setattr(mod, n, nn.Parameter(p.detach().expand(
                        (stack,) + tuple(p.shape)).clone()))

    def qkv(self, h: torch.Tensor, call=_direct) -> tuple:
        """Head-major projections: q (B, T, H, D), k/v (B, T, H_kv, D),
        the head counts those of the (local) kernels."""
        b, t, _ = h.shape
        hd = self.head_dim
        if self.n_kv_heads is None:
            qkv = call(self.wqkv, h).reshape(b, t, -1, 3, hd)
            return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        q = call(self.wq, h).reshape(b, t, -1, hd)
        kv = call(self.wkv, h).reshape(b, t, -1, 2, hd)
        return q, kv[..., 0, :], kv[..., 1, :]

    def attention_inputs(self, x, positions, call=_direct) -> tuple:
        """q, k, v of ``x`` with RoPE at ``positions`` applied to q and
        k."""
        q, k, v = self.qkv(call(self.ln1, x), call)
        return rope(q, positions), rope(k, positions), v

    def project(self, attn: torch.Tensor, call=_direct) -> torch.Tensor:
        """The output projection of the (B, T, H, D) attention (under tp
        this rank's partial sum)."""
        b, t, h, d = attn.shape
        return call(self.wo, attn.reshape(b, t, h * d))

    def mlp_out(self, x: torch.Tensor, call=_direct) -> torch.Tensor:
        """The MLP's output before its cast to the residual's dtype (under
        tp this rank's partial sum; fp32 from `QuantDense`)."""
        return call(self.wo_mlp, gelu(call(self.wi, call(self.ln2, x))))


class TransformerLM(nn.Module):
    """Decoder-only LM: (B, T) int64 tokens -> (B, T, vocab) fp32 logits.

    Parameters are fp32, created on ``device`` (``cuda`` unless the
    caller asks for ``cpu``) and left uninitialized until `init_weights`
    or `interop.load_jax_params` fills them; ``dtype`` (fp32 or bf16) is
    the compute dtype.  ``tp_axis``/``tp_size``: the tensor-parallel
    axis and the number of shards the parameters are cut into (module
    docstring)."""

    def __init__(self, vocab_size: int = 32000, d_model: int = 512,
                 n_layers: int = 4, n_heads: int = 8,
                 n_kv_heads: Optional[int] = None, d_ff: int = 2048,
                 device="cuda", *, attn_impl: str = "xla",
                 flash_bwd: str = "chunked", ffn_exp: int = 8,
                 ffn_man: int = 23, ffn_mode: str = "faithful",
                 dropout_rate: float = 0.0, remat: bool = False,
                 scan_layers: bool = False, dtype=torch.float32,
                 sp_axis: Optional[str] = None, sp_mode: str = "ring",
                 tp_axis: Optional[str] = None, tp_size: int = 1):
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
        if tp_size < 1 or (tp_size > 1 and tp_axis is None):
            raise ValueError(f"tp_size={tp_size} needs tp_axis and >= 1")
        for what, n in (("n_heads", n_heads),
                        ("n_kv_heads", n_kv_heads or n_heads),
                        ("d_ff", d_ff)):
            if n % tp_size:
                raise ValueError(f"{what} {n} not divisible by tp_size "
                                 f"{tp_size}")
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.d_ff = d_ff
        self.remat = remat
        self.scan_layers = scan_layers
        self.dropout_rate = dropout_rate
        self.attn_impl = attn_impl
        self.flash_bwd = flash_bwd
        self.sp_axis = sp_axis
        self.sp_mode = sp_mode
        self.tp_axis = tp_axis
        self.tp_size = tp_size
        self.embed = Embed(vocab_size, d_model, dev, dtype)
        block_kw = dict(attn_impl=attn_impl, flash_bwd=flash_bwd,
                        ffn_exp=ffn_exp, ffn_man=ffn_man, ffn_mode=ffn_mode,
                        dtype=dtype, dropout_rate=dropout_rate,
                        tp_size=tp_size)
        if scan_layers:
            self.blocks = Block(d_model, n_heads, n_kv_heads, d_ff, dev,
                                stack=n_layers, **block_kw)
        else:
            self.blocks = nn.ModuleList(
                Block(d_model, n_heads, n_kv_heads, d_ff, dev, index=i,
                      **block_kw) for i in range(n_layers))
        self.ln_f = LayerNorm(d_model, dev, dtype)

    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights from ``generator`` (flax's default scales:
        Dense kernels N(0, 1/fan_in), embedding N(0, 1/d_model);
        LayerNorm scale 1 and bias 0).  The fan-in is the kernel's own:
        draw a tp shard's weights at ``tp_size`` 1 and `load_shard`
        them."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("kernel"):
                    std = p.shape[-2] ** -0.5
                elif name.endswith("embedding"):
                    std = p.shape[1] ** -0.5
                else:
                    p.fill_(1.0 if name.endswith("scale") else 0.0)
                    continue
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * std)
        return self

    def load_shard(self, full, tp_index: int) -> "TransformerLM":
        """Copy tp rank ``tp_index``'s shard of ``full`` (a full-width
        model of the same configuration, or its {name: tensor}) into this
        ``tp_size``-shard model, in place."""
        named = dict(full.named_parameters() if hasattr(
            full, "named_parameters") else full)
        specs = lm_param_specs(named)
        with torch.no_grad():
            for n, p in self.named_parameters():
                p.copy_(shard_param(named[n], specs[n][0], tp_index,
                                    self.tp_size))
        return self

    def _drop(self, blk: Block, x: torch.Tensor, key, layer: int,
              site: int) -> torch.Tensor:
        if not blk.dropout_rate or not blk.training:
            return x
        if key is None:
            raise ValueError("dropout in training needs the step's key "
                             "(flax: rngs={'dropout': key})")
        k = (scan_dropout_key(key, layer, self.n_layers, site)
             if self.scan_layers else dropout_key(key, layer, site))
        return dropout(x, blk.dropout_rate, k)

    def _layer(self, i, sp, tp, calls, pos, keys, *xs) -> list:
        """Layer ``i`` on every rank of the group (module docstring)."""
        if self.scan_layers:
            blk = self.blocks
            calls = [c.layer(blk, i) for c in calls]
        else:
            blk = self.blocks[i]
        qkv = [blk.attention_inputs(x, p, c)
               for x, p, c in zip(xs, pos, calls)]
        qs, ks, vs = zip(*qkv)
        if self.sp_axis is None or sp is None:
            attn = [grouped_query_attention(q, k, v, causal=True,
                                            impl=blk.attn_impl,
                                            flash_bwd=blk.flash_bwd)
                    for q, k, v in qkv]
        elif self.sp_mode == "ulysses":
            attn = ulysses_attention(qs, ks, vs, sp, causal=True,
                                     impl=self.attn_impl,
                                     flash_bwd=self.flash_bwd)
        else:
            attn = ring_attention(qs, ks, vs, sp, causal=True,
                                  impl=("chunked" if self.attn_impl ==
                                        "chunked" else "xla"))
        proj = [blk.project(a, c) for a, c in zip(attn, calls)]
        if tp is not None:
            proj = tp.psum(proj)
        xs = [x + self._drop(blk, p, k, i, 0)
              for x, p, k in zip(xs, proj, keys)]
        out = [blk.mlp_out(x, c) for x, c in zip(xs, calls)]
        if tp is not None:
            # fp32 from QuantDense: summed before the cast
            out = tp.psum(out)
        return [x + self._drop(blk, y.to(x.dtype), k, i, 1)
                for x, y, k in zip(xs, out, keys)]

    def _layers(self, sp, tp, calls, pos, keys, xs) -> list:
        for i in range(self.n_layers):
            if self.remat and torch.is_grad_enabled():
                xs = checkpoint(self._layer, i, sp, tp, calls, pos, keys,
                                *xs, use_reentrant=False)
            else:
                xs = self._layer(i, sp, tp, calls, pos, keys, *xs)
        return xs

    def _own_call(self):
        # scanned layers index their stacked leaves: bind them
        return (_Bound(self, dict(self.named_parameters()))
                if self.scan_layers else _direct)

    def forward(self, tokens: torch.Tensor, key=None) -> torch.Tensor:
        """The full sequence on one device; ``key``: the step's dropout
        key (needed in training with ``dropout_rate > 0``)."""
        if self.tp_size > 1:
            raise ValueError("a model holding one tp shard runs through "
                             "forward_sp with its tp view")
        b, t = tokens.shape
        pos = torch.arange(t, device=tokens.device).expand(b, t)
        x = self.embed(tokens)
        (x,) = self._layers(None, None, [self._own_call()], [pos], [key],
                            [x])
        x = self.ln_f(x)
        return self.embed.attend(x).to(torch.float32)

    def forward_sp(self, tokens, sp, params=None, keys=None,
                   tp=None) -> list:
        """The forward over a group of ranks (module docstring):
        ``tokens`` one (B, T_local) block per local rank of one dp index,
        ``sp`` and ``tp`` the mesh's views over those ranks (``sp.ranks``
        their sp indices; ``tp`` None or of size 1 without tensor
        parallelism), ``params`` None (the module's own weights: a
        `ProcessMesh` rank, or on a `LocalMesh` each tp rank's
        `rank_params`) or one {name: tensor} dict per rank, ``keys`` each
        rank's dropout key.  Returns each rank's (B, T_local, vocab) fp32
        logits."""
        if self.sp_axis is None and self.tp_axis is None:
            raise ValueError("forward_sp needs a model built with sp_axis "
                             "or tp_axis")
        n = len(tokens)
        b, t = tokens[0].shape
        dev = tokens[0].device
        tp_world = 1 if tp is None else tp.world
        if tp_world > 1:
            if self.tp_axis is None:
                raise ValueError(f"a tp view of {tp_world} ranks needs a "
                                 "model built with tp_axis")
            if self.tp_size == 1:
                if params is None:
                    params = [rank_params(self, r, tp_world)
                              for r in tp.ranks]
            elif self.tp_size != tp_world or tp.is_local:
                raise ValueError(
                    f"a model of tp_size={self.tp_size} holds one shard: "
                    f"one rank a process of a tp={tp_world} ProcessMesh")
        elif self.tp_size > 1:
            raise ValueError(f"a model of tp_size={self.tp_size} needs the "
                             "mesh's tp view")
        calls = ([self._own_call()] * n if params is None
                 else [_Bound(self, p) for p in params])
        keys = [None] * n if keys is None else list(keys)
        pos = [(r * t + torch.arange(t, device=dev)).expand(b, t)
               for r in sp.ranks]
        xs = [c(self.embed, tk) for c, tk in zip(calls, tokens)]
        xs = self._layers(sp, tp if tp_world > 1 else None, calls, pos,
                          keys, xs)
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
