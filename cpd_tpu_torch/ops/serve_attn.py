"""Fused gather -> digest -> unpack -> attention for the paged eXmY KV
cache: the serving decode hot path as one kernel launch per layer.

Port of `cpd_tpu/ops/serve_attn.py` (`fused_gather_attention`, whose
Pallas body is `_fused_kernel`).  Three functions:

* `paged_attention` — plain PyTorch masked GQA decode attention over a
  gathered capacity window (the JAX `serve.model._paged_attention`);
* `fused_gather_attention_ref` — the plain version of the whole fused
  function: gather the page rows, digest each gathered page as read,
  unpack, attend;
* `fused_gather_attention` — the wrapper.  It checks its arguments on
  every device (`check_call`); for CPU tensors it runs the plain version;
  for CUDA tensors it launches the hand-written kernel in
  ``csrc/serve_attn.cu`` (built at first use, `ops.build`) or raises.
  There is no fallback from the card to the plain version;
* `core_launcher` — the serial kernel of the same source (one CTA per
  slot and kv head walking the pages in order), which no path calls: the
  yardstick ``chip_smoke.py`` times the kernel against.

The kernel is split-K over pages: one CTA per (slot, page, part of a
page) reads the part's bytes once, digests them and, where a key of the
part is at or before the query, writes a partial softmax; a second small
kernel merges the partials in part order and sums the digests.  One call
returns both outputs: ``attn`` (S, 1, H, D) fp32 and the per-gathered-
page digests (S, max_pages), int64 holding the JAX package's uint32
values, as everywhere in the port.  Page ids outside the pool are
clamped into it, as the JAX gather clamps them.  Every rep, head_dim and
page_size the cache config takes is served: a page whose staging does
not fit `UNIT_BUDGET` bytes of shared memory is cut into parts.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..parallel.integrity import row_digests

__all__ = ["paged_attention", "fused_gather_attention",
           "fused_gather_attention_ref", "check_call", "split_plan",
           "core_launcher", "UNIT_BUDGET"]

_NEG_INF = -1e30

# shared memory one CTA of the split kernel may stage a page part in,
# bytes: two CTAs fit one SM's 227 KB
UNIT_BUDGET = 96 * 1024
# fp32 query values a CTA stages at once (32 KB)
_Q_FLOATS = 8192


def _scale(d: int) -> float:
    """The softmax scale ``1 / sqrt(D)`` in fp32, the kernel's too."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, last_pos: torch.Tensor) -> torch.Tensor:
    """GQA softmax attention against a gathered capacity window.

    q: (B, T, H, D); k/v: (B, T_cap, H_kv, D); q_pos: (B, T) global query
    positions; last_pos: (B,) newest LIVE position per slot.  K/V past
    ``last_pos`` are zeroed before any product (a reused page may hold a
    previous tenant's bytes, NaN-coded ones included), then the mask
    ``key_pos <= query_pos`` fills -1e30; fp32 softmax."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = _scale(d)
    ki = torch.arange(k.shape[1], device=q.device)
    live = (ki[None, :] <= last_pos.long()[:, None])[..., None, None]
    k = torch.where(live, k, 0.0)
    v = torch.where(live, v, 0.0)
    qg = q.reshape(b, t, hkv, rep, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * scale
    mask = ki[None, None, :] <= q_pos.long()[:, :, None]       # (B, T, T_cap)
    logits = torch.where(mask[:, None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, t, h, d)


def fused_gather_attention_ref(pool_layer: torch.Tensor, q: torch.Tensor,
                               page_rows: torch.Tensor,
                               positions: torch.Tensor,
                               last_pos: torch.Tensor, *, cfg) -> tuple:
    """Plain PyTorch version of the fused function: gather -> page
    digests -> `unpack_kv` -> `paged_attention`."""
    from ..serve.kvcache import unpack_kv   # serve imports this module

    s_count, max_pages = page_rows.shape
    rows = page_rows.long().clamp(0, pool_layer.shape[0] - 1)
    kv = pool_layer[rows]                    # (S, MP, 2, page, ...)
    dig = row_digests(kv.reshape(s_count * max_pages, -1)).reshape(
        s_count, max_pages)
    un = unpack_kv(kv, cfg)                  # (S, MP, 2, page, H_kv, D)
    t_cap = max_pages * cfg.page_size
    k = un[:, :, 0].reshape(s_count, t_cap, cfg.n_kv_heads, cfg.head_dim)
    v = un[:, :, 1].reshape(s_count, t_cap, cfg.n_kv_heads, cfg.head_dim)
    return paged_attention(q, k, v, positions, last_pos), dig


def _check(name: str, x: torch.Tensor, dtype, shape: tuple) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_call(pool_layer: torch.Tensor, q: torch.Tensor,
               page_rows: torch.Tensor, positions: torch.Tensor,
               last_pos: torch.Tensor, cfg) -> torch.device:
    """What `fused_gather_attention` takes, checked on every device:
    inputs on one device, decode queries (T == 1) of the cache's head_dim
    and a multiple of its kv heads, at least one page per table row, each
    tensor of its dtype, shape and contiguous.  Returns the device."""
    tensors = (pool_layer, q, page_rows, positions, last_pos)
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError("inputs on several devices: "
                         f"{sorted(map(str, devices))}")
    s_count, t, h, d = q.shape
    if t != 1:
        raise ValueError(f"the fused kernel is decode-only (T == 1), got "
                         f"T={t}; prefill reads the cache through "
                         "gather_kv + paged_attention")
    hkv = cfg.n_kv_heads
    if d != cfg.head_dim or h % hkv:
        raise ValueError(f"q heads/dim ({h}, {d}) do not fit the cache's "
                         f"({hkv}, {cfg.head_dim})")
    if page_rows.dim() != 2 or page_rows.shape[1] < 1:
        raise ValueError(f"page_rows {tuple(page_rows.shape)}: (S, max_pages"
                         ") with max_pages >= 1")
    _check("pool_layer", pool_layer, torch.uint8, cfg.pool_shape[1:])
    _check("q", q, torch.float32, (s_count, 1, h, d))
    _check("page_rows", page_rows, torch.int32,
           (s_count, page_rows.shape[1]))
    _check("positions", positions, torch.int32, (s_count, 1))
    _check("last_pos", last_pos, torch.int32, (s_count,))
    return devices.pop()


@functools.lru_cache(maxsize=None)
def split_plan(cfg, rep: int) -> tuple:
    """``(unit, heads, q_rows)`` of the split kernel for a cache config and
    GQA ratio: the positions of a page one CTA takes (the whole page where
    its staging fits `UNIT_BUDGET`, else the page cut into equal parts),
    the query heads of one pass over a kv head, and the query rows staged
    at once (all H where they fit 32 KB, else one pass's).  The bytes
    follow the kernel's ``split_smem``: a 256-entry table, the part's K
    and V bytes, one kv head's decoded K and V tiles [unit][D + 1], the
    query rows and one pass's logits [heads][unit], fp32."""
    d, rb = cfg.head_dim, cfg.row_bytes
    h = cfg.n_kv_heads * rep
    heads = rep if rep * d <= _Q_FLOATS else max(1, _Q_FLOATS // d)
    q_rows = h if heads == rep and h * d <= _Q_FLOATS else heads
    fixed = 256 * 4 + 16 + 4 * q_rows * d
    per_position = 2 * rb + 8 * (d + 1) + 4 * heads
    fit = max(1, (UNIT_BUDGET - fixed) // per_position)
    n_split = -(-cfg.page_size // fit)
    return -(-cfg.page_size // n_split), heads, q_rows


def _library():
    from .build import load_library

    lib = load_library("serve_attn")
    if not getattr(lib, "_cpd_typed", False):
        fn = lib.serve_attn_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 15 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.serve_attn_serial_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.serve_attn_error_string.argtypes = [ctypes.c_int]
        lib.serve_attn_error_string.restype = ctypes.c_char_p
        lib._cpd_typed = True
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.serve_attn_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {rc})")


def fused_gather_attention(pool_layer: torch.Tensor, q: torch.Tensor,
                           page_rows: torch.Tensor, positions: torch.Tensor,
                           last_pos: torch.Tensor, *, cfg) -> tuple:
    """One decode batch's paged attention in a single pass over the pages.

    pool_layer: ONE layer's pool slice, (n_pages, 2, page, H_kv, D, WB)
    uint8 or (n_pages, 2, page, row_bytes) blocked; q: (S, 1, H, D) fp32;
    page_rows: (S, max_pages) int32; positions: (S, 1) int32; last_pos:
    (S,) int32; ``cfg``: the pool's `KVCacheConfig`.

    Returns ``(attn, page_digests)``: (S, 1, H, D) fp32 and (S,
    max_pages) int64 digests of every gathered page as read.  CPU
    tensors take `fused_gather_attention_ref`; CUDA tensors launch the
    kernel (its split and combine kernels), counted once per call in
    ``fused_gather_attention.launches``."""
    dev = check_call(pool_layer, q, page_rows, positions, last_pos, cfg)
    if dev.type == "cpu":
        return fused_gather_attention_ref(pool_layer, q, page_rows,
                                          positions, last_pos, cfg=cfg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    s_count, _, h, d = q.shape
    hkv, max_pages = cfg.n_kv_heads, page_rows.shape[1]
    rep = h // hkv
    unit, heads, q_rows = split_plan(cfg, rep)
    n_split = -(-cfg.page_size // unit)
    attn = torch.empty((s_count, 1, h, d), dtype=torch.float32, device=dev)
    dig = torch.empty((s_count, max_pages), dtype=torch.int64, device=dev)
    part = torch.empty((s_count, h, max_pages * n_split, d + 2),
                       dtype=torch.float32, device=dev)
    dpart = torch.empty((s_count, max_pages, n_split, 2), dtype=torch.int32,
                        device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.serve_attn_launch(
            pool_layer.data_ptr(), q.data_ptr(), page_rows.data_ptr(),
            positions.data_ptr(), last_pos.data_ptr(), attn.data_ptr(),
            dig.data_ptr(), part.data_ptr(), dpart.data_ptr(), s_count,
            max_pages, pool_layer.shape[0], cfg.page_size, hkv, rep, d,
            cfg.row_bytes, cfg.word_bytes, cfg.exp_bits, cfg.man_bits,
            cfg.block_size if cfg.block_scale else 0, unit, heads, q_rows,
            _scale(d), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "serve_attn")
    fused_gather_attention.launches += 1
    return attn, dig


fused_gather_attention.launches = 0


def _serial_launch(pool_layer, q, page_rows, positions, last_pos,
                   cfg) -> tuple:
    """The serial kernel on checked CUDA tensors: ``(attn, digests)`` as
    `fused_gather_attention` returns them (its uint32 digests widened to
    int64 by two torch ops, as its wrapper did).  It takes head_dim <= 256,
    rep <= 16 and a page's fp32 K and V tiles within 48 KB, and raises
    on the rest."""
    dev = check_call(pool_layer, q, page_rows, positions, last_pos, cfg)
    s_count, _, h, d = q.shape
    hkv, max_pages = cfg.n_kv_heads, page_rows.shape[1]
    rep = h // hkv
    if d > 256 or rep > 16 or 2 * cfg.page_size * d * 4 > 48 * 1024:
        raise ValueError(f"the serial kernel takes head_dim <= 256, rep <= "
                         f"16 and 2 * page * D * 4 <= 48 KB, got D={d}, "
                         f"rep={rep}, page={cfg.page_size}")
    attn = torch.empty((s_count, 1, h, d), dtype=torch.float32, device=dev)
    dig = torch.empty((s_count, max_pages), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.serve_attn_serial_launch(
            pool_layer.data_ptr(), q.data_ptr(), page_rows.data_ptr(),
            positions.data_ptr(), last_pos.data_ptr(), attn.data_ptr(),
            dig.data_ptr(), s_count, max_pages, pool_layer.shape[0],
            cfg.page_size, hkv, rep, d, cfg.row_bytes, cfg.word_bytes,
            cfg.exp_bits, cfg.man_bits,
            cfg.block_size if cfg.block_scale else 0,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "serve_attn (serial)")
    return attn, dig.to(torch.int64) & 0xFFFFFFFF


def core_launcher():
    """The launch function of the serial kernel, K12's yardstick:
    ``fn(pool_layer, q, page_rows, positions, last_pos, cfg)``.  No path
    calls it; ``chip_smoke.py`` times the split kernel against it."""
    return _serial_launch
