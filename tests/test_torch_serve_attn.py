"""The port's fused paged-attention function vs the JAX Pallas kernel.

`cpd_tpu_torch.ops.serve_attn.fused_gather_attention_ref` (the plain
version the port's CUDA kernel is held against on the card) and the JAX
`fused_gather_attention` (run in Pallas interpret mode, as
tests/test_serve_tp.py runs it on the CPU) read the SAME pool bytes.
Digests must agree bit for bit.  Attention agrees to ATTN_ATOL: both are
fp32, but XLA's and ATen's contractions and softmax sum in different
orders, so the last bits differ (measured ~1e-7 at these sizes).

Shapes: GQA 2:1 to 32:1, MHA, head_dim 8 to 128, pages of 2 to 64
positions, a long page table (64 pages), per-tensor and blocked codecs
of one to four bytes, trash padding, and a slot whose query position is
negative (every key masked: uniform weights over all t_cap keys).

The CUDA kernel itself cannot run here.  `test_split_model_matches_plain`
holds a torch model of its algorithm (`split_plan`'s parts of a page,
the live prefix, each part's partial softmax merged in part order, the
digest summed over parts) to the plain version, and the wrapper's
contract check runs on every device; `test_kernel_matches_plain_on_card`
holds the kernel itself against the plain version where a card exists.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cpd_tpu.ops import fused_gather_attention as jax_fused
from cpd_tpu.serve import kvcache as jkv
from cpd_tpu.serve.model import _paged_attention as jax_attention
from cpd_tpu_torch.ops import serve_attn
from cpd_tpu_torch.serve import kvcache as tkv

ATTN_ATOL = 2e-5

SHAPES = [
    # h, hkv, d, page, max_pages, fmt, block[, query positions]
    (4, 2, 8, 4, 3, (4, 3), None),      # GQA 2:1, odd tail page
    (4, 4, 8, 4, 2, (8, 23), None),     # MHA, the lossless byte split
    (8, 2, 16, 2, 3, (5, 2), None),     # GQA 4:1, tiny pages
    (4, 2, 8, 4, 3, (4, 3), 12),        # blocked sidecar, odd blocks
    (8, 2, 8, 4, 4, (5, 7), 5),         # two-byte codes, blocked
    (16, 2, 8, 4, 3, (4, 3), None),     # rep 8
    (32, 1, 8, 4, 3, (5, 2), None),     # rep 32
    (4, 2, 128, 64, 2, (4, 3), None),   # head_dim 128, page 64 (split)
    (4, 2, 8, 4, 3, (4, 3), None, "neg"),   # slot 1's q_pos < 0
    (4, 2, 8, 2, 64, (5, 2), None),     # a long table: 64 pages
]


def _case(h, hkv, d, page, mp, fmt, block, *rest, seed):
    """A pool of packed random K/V, page tables of distinct pages (slot
    2's trash-padded past its first page), live lengths and queries.
    ``rest`` = ("neg",) gives slot 1 the query position -1; elsewhere a
    slot's query position is its last live one."""
    n_pages = max(13, 3 * mp + 1)
    kw = dict(n_layers=1, n_pages=n_pages, page_size=page, n_kv_heads=hkv,
              head_dim=d, exp_bits=fmt[0], man_bits=fmt[1],
              block_scale=block is not None, block_size=block or 32)
    jc, tc = jkv.KVCacheConfig(**kw), tkv.KVCacheConfig(**kw)
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((n_pages, 2, page, hkv, d)).astype(np.float32)
    pool = np.array(jkv.pack_kv(jnp.asarray(raw), jc))
    rows = rng.choice(np.arange(1, n_pages), size=(3, mp),
                      replace=False).astype(np.int32)
    rows[2, 1:] = 0                                      # trash padding
    last = np.array([mp * page - 2, page + 1, page - 1], np.int32)
    q = rng.standard_normal((3, 1, h, d)).astype(np.float32)
    pos = last[:, None] + 0
    if rest == ("neg",):
        pos[1] = -1
    return jc, tc, pool, rows, last, q, pos


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_kernel(shape):
    jc, tc, pool, rows, last, q, pos = _case(*shape, seed=sum(shape[:5]))
    want, want_dig = jax_fused(
        jnp.asarray(pool), jnp.asarray(q), jnp.asarray(rows),
        jnp.asarray(pos), jnp.asarray(last), page_size=jc.page_size,
        unpack_fn=lambda kvp: jkv.unpack_kv(kvp, jc),
        attend_fn=jax_attention, interpret=True)
    args = [torch.from_numpy(a.copy()) for a in (pool, q, rows, pos, last)]
    got, dig = serve_attn.fused_gather_attention_ref(*args, cfg=tc)
    np.testing.assert_array_equal(np.asarray(want_dig).astype(np.int64),
                                  dig.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_ATOL)


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper IS the plain version (bit for bit) and
    launches nothing."""
    _, tc, pool, rows, last, q, pos = _case(*SHAPES[0], seed=3)
    args = [torch.from_numpy(a.copy()) for a in (pool, q, rows, pos, last)]
    before = serve_attn.fused_gather_attention.launches
    a, da = serve_attn.fused_gather_attention(*args, cfg=tc)
    b, db = serve_attn.fused_gather_attention_ref(*args, cfg=tc)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(da, db)
    assert serve_attn.fused_gather_attention.launches == before


def test_dead_tail_nan_never_reaches_live_output():
    """NaN-coded bytes past a slot's last live position (a reused page's
    previous tenant) are zeroed before any product."""
    jc, tc, pool, rows, last, q, _ = _case(*SHAPES[0], seed=4)
    nan = np.asarray(jkv.pack_kv(jnp.full((1, 1), np.nan, jnp.float32),
                                 jc)).reshape(-1)
    for s in range(3):
        page = rows[s, last[s] // jc.page_size]
        pool[page, :, last[s] % jc.page_size + 1:] = nan
    pool[0] = nan
    args = [torch.from_numpy(a.copy())
            for a in (pool, q, rows, last[:, None], last)]
    out, _ = serve_attn.fused_gather_attention_ref(*args, cfg=tc)
    assert torch.isfinite(out).all()


def test_mixed_devices_rejected():
    _, tc, pool, rows, last, q, pos = _case(*SHAPES[0], seed=5)
    args = [torch.from_numpy(a.copy()) for a in (pool, q, rows, pos, last)]
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        serve_attn.fused_gather_attention(*args, cfg=tc)


@pytest.mark.parametrize("shape", SHAPES)
def test_contract_check_accepts_every_shape(shape):
    """The wrapper's contract check runs on every device: the shapes the
    serial kernel refused (rep 8 and 32, page 64 x head_dim 128, a negative
    query position, 64 pages) pass it, the CPU wrapper serves them, and
    the split plan covers each page with parts that fit `UNIT_BUDGET`."""
    _, tc, pool, rows, last, q, pos = _case(*shape, seed=6)
    args = [torch.from_numpy(a.copy()) for a in (pool, q, rows, pos, last)]
    assert serve_attn.check_call(*args, tc) == torch.device("cpu")
    attn, dig = serve_attn.fused_gather_attention(*args, cfg=tc)
    assert attn.shape == q.shape and dig.shape == rows.shape
    rep = q.shape[2] // tc.n_kv_heads
    unit, heads, q_rows = serve_attn.split_plan(tc, rep)
    n_split = -(-tc.page_size // unit)
    assert 1 <= unit <= tc.page_size and (n_split - 1) * unit < tc.page_size
    assert 1 <= heads <= rep and q_rows in (heads, q.shape[2])
    staged = (1024 + 16 + 2 * unit * tc.row_bytes
              + 4 * (2 * unit * (tc.head_dim + 1) + q_rows * tc.head_dim
                     + heads * unit))
    assert staged <= serve_attn.UNIT_BUDGET


def test_split_plan_cuts_only_what_does_not_fit():
    """A page is one part where its staging fits (the serving slice's
    page 16), cut into equal parts where it does not (page 64 x head_dim
    128 at GQA 4:1 in e4m3, about 100 KB whole)."""
    kw = dict(n_layers=1, n_pages=9, n_kv_heads=2, exp_bits=4, man_bits=3)
    assert serve_attn.split_plan(
        tkv.KVCacheConfig(page_size=16, head_dim=64, **kw), 4) == (16, 4, 8)
    assert serve_attn.split_plan(
        tkv.KVCacheConfig(page_size=64, head_dim=128, **kw), 4) == (32, 4, 8)
    # 64 query heads of 256 floats do not fit 32 KB at once: a pass's
    assert serve_attn.split_plan(
        tkv.KVCacheConfig(page_size=16, head_dim=256, **kw), 32) == (
        16, 32, 32)


def _split_model(pool, q, rows, pos, last, cfg):
    """The split kernel's algorithm in torch, fp32: per slot, each part of
    each gathered page (`split_plan`) digests its K and V bytes; a part
    at or before the last key (all of them when q_pos < 0) gives a
    partial (m, l, acc) per query head over its keys; the live parts, a
    prefix in part order, merge in that order."""
    from cpd_tpu_torch.parallel.integrity import DIGEST_MOD
    from cpd_tpu_torch.serve.kvcache import unpack_kv

    s_count, mp = rows.shape
    h, d = q.shape[2], q.shape[3]
    page, hkv = cfg.page_size, cfg.n_kv_heads
    rep = h // hkv
    unit, _, _ = serve_attn.split_plan(cfg, rep)
    n_split = -(-page // unit)
    t_cap, rb = mp * page, cfg.row_bytes
    scale = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(d)))
    ids = rows.long().clamp(0, pool.shape[0] - 1)
    flat = pool.reshape(pool.shape[0], 2, page, rb)
    out = torch.empty(s_count, 1, h, d)
    dig = torch.empty(s_count, mp, dtype=torch.int64)
    for s in range(s_count):
        qpos, lp = int(pos[s, 0]), int(last[s])
        kend = min(qpos, t_cap - 1) if qpos >= 0 else t_cap - 1
        parts = []
        for pg in range(mp):
            page_bytes = flat[ids[s, pg]]                # (2, page, rb)
            s1 = s2 = 0
            for k in range(n_split):
                j0 = k * unit
                np_ = min(unit, page - j0)
                for plane in range(2):
                    w = page_bytes[plane, j0:j0 + np_].reshape(-1).long()
                    off = plane * page * rb + j0 * rb + torch.arange(
                        w.numel())
                    s1 = (s1 + int(w.sum())) % DIGEST_MOD
                    s2 = (s2 + int((w * (off % DIGEST_MOD + 1)).sum())
                          ) % DIGEST_MOD
                t0 = pg * page + j0
                nk = max(0, min(kend - t0 + 1, np_))
                if nk == 0:
                    continue
                kv = unpack_kv(pool[ids[s, pg]], cfg)    # (2, page, hkv, d)
                live = (torch.arange(t0, t0 + nk) <= lp)[:, None, None]
                kk = torch.where(live, kv[0, j0:j0 + nk], 0.0)
                vv = torch.where(live, kv[1, j0:j0 + nk], 0.0)
                kk = kk.repeat_interleave(rep, dim=1)    # (nk, h, d)
                vv = vv.repeat_interleave(rep, dim=1)
                if qpos >= 0:
                    lg = torch.einsum("hd,jhd->hj", q[s, 0], kk) * scale
                else:
                    lg = torch.full((h, nk), -1e30)
                m = lg.max(dim=1).values
                e = torch.exp(lg - m[:, None])
                parts.append((m, e.sum(1), torch.einsum("hj,jhd->hd", e,
                                                        vv)))
            dig[s, pg] = (s2 << 16) | s1
        m = torch.stack([p[0] for p in parts]).max(dim=0).values
        w = [torch.exp(p[0] - m) for p in parts]
        l = sum(wi * p[1] for wi, p in zip(w, parts))
        acc = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
        out[s, 0] = acc / l[:, None]
    return out, dig


@pytest.mark.parametrize("shape", SHAPES)
def test_split_model_matches_plain(shape):
    """The kernel's algorithm (parts, live prefix, in-order merge, digest
    parts) against the plain version: digests bitwise, attention within
    ATTN_ATOL; the NaN-coded tail of a reused page never reaches it."""
    jc, tc, pool, rows, last, q, pos = _case(*shape, seed=8)
    if not tc.block_scale:
        nan = np.asarray(jkv.pack_kv(jnp.full((1, 1), np.nan, jnp.float32),
                                     jc)).reshape(-1)
        page = rows[0, last[0] // tc.page_size]
        pool[page, :, last[0] % tc.page_size + 1:] = nan
    args = [torch.from_numpy(a.copy()) for a in (pool, q, rows, pos, last)]
    got, dig = _split_model(*args, tc)
    want, want_dig = serve_attn.fused_gather_attention_ref(*args, cfg=tc)
    assert torch.equal(dig, want_dig)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=ATTN_ATOL)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_on_card(shape):
    _card()
    _, tc, pool, rows, last, q, pos = _case(*shape, seed=7)
    args = [torch.from_numpy(a.copy()).cuda()
            for a in (pool, q, rows, pos, last)]
    before = serve_attn.fused_gather_attention.launches
    got, dig = serve_attn.fused_gather_attention(*args, cfg=tc)
    again, dig2 = serve_attn.fused_gather_attention(*args, cfg=tc)
    torch.cuda.synchronize()
    assert serve_attn.fused_gather_attention.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(dig, dig2)
    want, want_dig = serve_attn.fused_gather_attention_ref(*args, cfg=tc)
    assert torch.equal(dig, want_dig)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)
    with pytest.raises(ValueError, match="decode-only"):
        serve_attn.fused_gather_attention(
            args[0], args[1].expand(-1, 2, -1, -1).contiguous(), *args[2:],
            cfg=tc)


@pytest.mark.cuda
def test_serial_kernel_matches_plain_on_card():
    """The kept serial kernel (the yardstick) on the shapes it takes."""
    _card()
    for shape in SHAPES[:6]:
        _, tc, pool, rows, last, q, pos = _case(*shape, seed=9)
        args = [torch.from_numpy(a.copy()).cuda()
                for a in (pool, q, rows, pos, last)]
        got, dig = serve_attn.core_launcher()(*args, tc)
        want, want_dig = serve_attn.fused_gather_attention_ref(*args, cfg=tc)
        assert torch.equal(dig, want_dig)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)
