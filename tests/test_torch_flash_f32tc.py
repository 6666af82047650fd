"""The fp32 tensor-core attention kernels (`csrc/flash_f32_tc.cu`: K9, K10
and K11's fp32 arm) from the CPU.

The kernels run only on the card, so what can be held here is held here:

* the kernels' arithmetic, emulated in torch (`_emulated_fwd`,
  `_emulated_bwd`): every product 3xTF32 (operands split by bit ops into
  hi = rna(x) and lo = rna(x - hi), rounding to TF32 to nearest with ties
  away, then lo*hi' + hi*lo' + hi*hi'), the online softmax over STEP-key
  tiles in log2 units, dq summed tile by tile, dk and dv summed per query
  head tile by tile and then over the rep heads in order.  It is held
  against JAX `flash_gqa` (the forward and LSE by `_flash_gqa_fwd_call` in
  interpret mode, the gradients by `jax.vjp` of the Pallas backward) and
  against the plain versions at half the tolerance the card holds the
  kernels to (EMU_SHARE of 1e-5 for out and LSE, of 1e-4 for gradients),
  so that any excess on the card is the kernels';
* why three products: one TF32 product misses the 1e-5 tolerance;
* the C interface parsed from the source against the ctypes table the
  wrapper sets, and the build registry;
* the wrappers' choice of library by element type (fp32: the 3xTF32
  kernels for K9/K10 and K11; bf16: flash_mha_tc.cu for K9/K10 and K11),
  one count per call.

The ``cuda``-marked tests hold the kernels against the plain versions on
the card over chip_smoke.py's fp32 cases and check that two launches are
bitwise equal.
"""

import ctypes
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops.flash_gqa import _flash_gqa_fwd_call
from cpd_tpu.ops.flash_gqa import flash_gqa as jflash
from cpd_tpu_torch.ops import build
from cpd_tpu_torch.ops import flash_gqa as tfl
from cpd_tpu_torch.ops import flash_mha as tfm

FWD_ATOL = 1e-5      # out, LSE: chip_smoke.py's FLASH_ATOL
GRAD_ATOL = 1e-4     # dq, dk, dv: chip_smoke.py's FLASH_GRAD_ATOL
EMU_SHARE = 0.5
STEP = 32            # keys (forward, dq) or queries (dk/dv) of a tile
LOG2E = np.float32(math.log2(math.e))
LN2 = np.float32(math.log(2.0))
# (B, T, H, H_kv, D, causal): rep 1, 2 and 4, causal and not, T = 200
# (pad past the 32-row tiles), head_dim 32, 64 and 128
CASES = [(1, 128, 4, 4, 32, True), (1, 200, 4, 2, 64, True),
         (1, 96, 8, 2, 128, False), (2, 64, 4, 1, 64, False)]
_SRC = os.path.join(os.path.dirname(build.__file__), "..", "csrc",
                    "flash_f32_tc.cu")


def _inputs(case, seed):
    """numpy-seeded fp32 q, k, v and an output cotangent."""
    b, t, h, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d),
                      (b, t, h, d))]


def _tf32(x):
    """fp32 ``x`` rounded to TF32 to nearest, ties away from zero: half a
    TF32 ulp added to the bit pattern, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b, products=3):
    """``a @ b`` in fp32 as the kernels take it: each operand split into
    hi = rna(x), lo = rna(x - hi), and the small products first.
    ``products=1`` takes hi @ hi' alone (one TF32 product)."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _heads(q, k, v):
    """(B, H, T, D) views of q and of k, v expanded to the query heads."""
    rep = q.shape[2] // k.shape[2]
    return (q.permute(0, 2, 1, 3),
            *(x.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
              for x in (k, v)))


def _visible(tq, k0, n, causal):
    qi = torch.arange(tq)[:, None]
    ki = k0 + torch.arange(n)[None, :]
    return ki <= qi if causal else torch.ones((tq, n), dtype=torch.bool)


def _emulated_fwd(q, k, v, causal, products=3):
    """The forward's order: ``(out (B, T, H, D), lse (B, H, T))``."""
    b, tq, h, d = q.shape
    qh, kh, vh = _heads(q, k, v)
    scale2 = np.float32(tfl._scale(d)) * LOG2E
    m = torch.full((b, h, tq), -1e30)
    l = torch.zeros((b, h, tq))
    acc = torch.zeros((b, h, tq, d))
    for k0 in range(0, k.shape[1], STEP):
        kt, vt = kh[:, :, k0:k0 + STEP], vh[:, :, k0:k0 + STEP]
        ok = _visible(tq, k0, kt.shape[2], causal)
        s = torch.where(ok, _mm3(qh, kt.transpose(-1, -2), products)
                        * scale2, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _mm3(p, vt, products)
        m = m_new
    den = torch.clamp(l, min=1e-30)
    return ((acc / den[..., None]).permute(0, 2, 1, 3),
            m * LN2 + torch.log(den))


def _emulated_bwd(q, k, v, out, lse, g, causal):
    """The backward's order: p and ds per element in fp32, dq summed over
    key tiles, dk and dv per query head over query tiles, then the rep
    heads of a kv head added in order."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = np.float32(tfl._scale(d))
    qh, kh, vh = _heads(q, k, v)
    gh = g.permute(0, 2, 1, 3)
    delta = (g * out).sum(-1).permute(0, 2, 1)
    ok = _visible(t, 0, t, causal)
    s = _mm3(qh, kh.transpose(-1, -2))
    p = torch.where(ok, torch.exp2(s * (scale * LOG2E)
                                   - (lse * LOG2E)[..., None]), 0.0)
    dp = _mm3(gh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.zeros((b, h, t, d))
    dkh = torch.zeros((b, h, t, d))
    dvh = torch.zeros((b, h, t, d))
    for r0 in range(0, t, STEP):
        rows = slice(r0, r0 + STEP)
        dq = dq + _mm3(ds[..., rows], kh[:, :, rows])
        dkh = dkh + _mm3(ds[:, :, rows].transpose(-1, -2), qh[:, :, rows])
        dvh = dvh + _mm3(p[:, :, rows].transpose(-1, -2), gh[:, :, rows])
    dk, dv = (x.reshape(b, hkv, rep, t, d) for x in (dkh, dvh))
    dk_sum, dv_sum = dk[:, :, 0], dv[:, :, 0]
    for r in range(1, rep):
        dk_sum, dv_sum = dk_sum + dk[:, :, r], dv_sum + dv[:, :, r]
    return (dq.permute(0, 2, 1, 3), dk_sum.permute(0, 2, 1, 3),
            dv_sum.permute(0, 2, 1, 3))


def _err(got, want):
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    return float((got.double() - want.double()).abs().max())


@pytest.mark.parametrize("case", CASES)
def test_emulated_forward_vs_jax_and_plain(case):
    b, t, h, hkv, d, causal = case
    q, k, v, _ = _inputs(case, seed=0)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _emulated_fwd(tq, tk, tv, causal)
    jo, jl = _flash_gqa_fwd_call(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, True)
    jl = np.asarray(jl)[..., :t].reshape(b, h, t)
    r_out, r_lse = tfl.flash_gqa_fwd_ref(tq, tk, tv, causal)
    for name, x, w in (("out vs JAX", out, jo), ("lse vs JAX", lse, jl),
                       ("out vs plain", out, r_out.numpy()),
                       ("lse vs plain", lse, r_lse.numpy())):
        assert _err(x, w) <= EMU_SHARE * FWD_ATOL, (name, _err(x, w))


@pytest.mark.parametrize("case", CASES)
def test_emulated_gradients_vs_jax_vjp_and_plain(case):
    causal = case[-1]
    q, k, v, g = _inputs(case, seed=1)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jflash(q_, k_, v_, causal, "pallas"),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = _emulated_fwd(tq, tk, tv, causal)
    got = _emulated_bwd(tq, tk, tv, out, lse, tg, causal)
    plain = tfl.flash_gqa_bwd_ref(tq, tk, tv, *tfl.flash_gqa_fwd_ref(
        tq, tk, tv, causal), tg, causal)
    for name, x, w, r in zip(("dq", "dk", "dv"), got, want, plain):
        assert x.shape == r.shape
        assert _err(x, w) <= EMU_SHARE * GRAD_ATOL, (name, "JAX",
                                                     _err(x, w))
        assert _err(x, r.numpy()) <= EMU_SHARE * GRAD_ATOL, (
            name, "plain", _err(x, r.numpy()))


def test_one_tf32_product_misses_the_tolerance():
    """hi*hi' alone (1xTF32) on the same inputs leaves out/LSE more than
    1e-5 from JAX: the two small products are what make it fp32."""
    case = CASES[1]
    b, t, h, _, _, causal = case
    q, k, v, _ = _inputs(case, seed=0)
    jo, jl = _flash_gqa_fwd_call(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, True)
    jl = np.asarray(jl)[..., :t].reshape(b, h, t)
    one = _emulated_fwd(*map(torch.from_numpy, (q, k, v)), causal,
                        products=1)
    three = _emulated_fwd(*map(torch.from_numpy, (q, k, v)), causal)
    assert max(_err(one[0], jo), _err(one[1], jl)) > FWD_ATOL
    assert max(_err(three[0], jo), _err(three[1], jl)) <= EMU_SHARE * FWD_ATOL


def test_tf32_split_rounds_to_nearest_ties_away():
    """The split's rounding on chosen bit patterns: below half an ulp
    down, half an ulp and above up (away from zero for either sign), an
    exact TF32 value kept, and hi + lo == x to 2^-22."""
    one = 0x3F800000
    pats = [one + 0x0FFF, one + 0x1000, one + 0x1001, one + 0x2000,
            0x7F7FEFFF]
    x = torch.tensor(pats, dtype=torch.int32).view(torch.float32)
    x = torch.cat([x, -x])
    got = _tf32(x).view(torch.int32) & 0x7FFFFFFF
    want = [one, one + 0x2000, one + 0x2000, one + 0x2000, 0x7F7FE000] * 2
    assert got.tolist() == want
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         .astype(np.float32))
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert float(((hi.double() + lo.double() - y.double()).abs()
                  / y.double().abs()).max()) <= 2.0 ** -22


def _c_kind(decl: str) -> str:
    """'pointer', 'string', 'int' or 'float' of a C declaration."""
    if "*" in decl:
        return "string" if "char" in decl else "pointer"
    return re.match(r"\s*(?:const\s+)?(int|float)\b", decl).group(1)


def _c_signatures() -> dict:
    """name -> (return kind, parameter kinds) of every ``extern "C"``
    function of csrc/flash_f32_tc.cu."""
    with open(_SRC) as fh:
        text = fh.read()
    return {name: (_c_kind(ret), [_c_kind(p) for p in params.split(",")])
            for ret, name, params in re.findall(
                r'extern "C" ([\w\s*]+?)\s*\b(\w+)\(([^)]*)\)', text)}


_CTYPES_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
                ctypes.c_float: "float", ctypes.c_char_p: "string"}


@pytest.mark.parametrize("name", sorted(tfl.F32TC_SIGNATURES))
def test_c_interface_matches_ctypes_signatures(name):
    """Each exported function's return and parameter kinds, in order, are
    what the wrapper tells ctypes."""
    sigs = _c_signatures()
    assert set(sigs) == set(tfl.F32TC_SIGNATURES)
    restype, argtypes = tfl.F32TC_SIGNATURES[name]
    assert sigs[name] == (_CTYPES_KIND[restype],
                          [_CTYPES_KIND[t] for t in argtypes])


def test_build_registry_names_the_source():
    assert build.KERNEL_SOURCES["flash_f32_tc"] == "flash_f32_tc.cu"
    with open(_SRC) as fh:
        text = fh.read()
    # every product on the TF32 tensor cores, tiles by cp.async, no library
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert "cp.async.cg.shared.global" in text
    assert "#include <torch" not in text and "wmma" not in text


def _recorders(monkeypatch, module, names):
    """Stand-ins for ``module``'s launchers: each records (library, what)
    and runs the plain version of its direction."""
    calls = []
    for attr, lib, ref in names:
        def launch(*args, lib=lib, ref=ref):
            calls.append((lib, args[-1]))
            return ref(*args[:-1])
        monkeypatch.setattr(module, attr, launch)
    return calls


@pytest.mark.parametrize("dtype, library", [(torch.float32, "f32tc"),
                                            (torch.bfloat16, "tc")])
def test_gqa_cuda_calls_launch_the_library_of_their_dtype(monkeypatch,
                                                          dtype, library):
    """K9/K10 on CUDA tensors: fp32 to the 3xTF32 kernels, bf16 to
    flash_mha_tc.cu's bf16 tensor-core kernels (not flash_gqa.cu's
    templates), once per call and counted (the launchers are stood in
    for, since the CPU has no card)."""
    monkeypatch.setattr(tfl, "_on_card", lambda *a, **k: True)
    calls = _recorders(monkeypatch, tfl, (
        ("_f32tc_fwd", "f32tc", tfl.flash_gqa_fwd_ref),
        ("_f32tc_bwd", "f32tc", tfl.flash_gqa_bwd_ref),
        ("_tc_fwd", "tc", tfl.flash_gqa_fwd_ref),
        ("_tc_bwd", "tc", tfl.flash_gqa_bwd_ref),
        ("_launch_fwd", "core", tfl.flash_gqa_fwd_ref),
        ("_launch_bwd", "core", tfl.flash_gqa_bwd_ref)))
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _inputs((1, 64, 4, 2, 32, True), seed=3))
    fwd0, bwd0 = tfl.flash_gqa_fwd.launches, tfl.flash_gqa_bwd.launches
    leaves = [x.requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(tfl.flash_gqa(*leaves, True, "pallas"), leaves, g)
    assert calls == [(library, "flash_gqa_fwd"), (library, "flash_gqa_bwd")]
    assert (tfl.flash_gqa_fwd.launches - fwd0,
            tfl.flash_gqa_bwd.launches - bwd0) == (1, 1)


@pytest.mark.parametrize("dtype, library", [(torch.float32, "f32tc"),
                                            (torch.bfloat16, "tc")])
def test_mha_cuda_calls_launch_the_library_of_their_dtype(monkeypatch,
                                                          dtype, library):
    """K11 on CUDA tensors: fp32 to the 3xTF32 kernels at rep = 1, bf16
    to flash_mha_tc.cu, once per call and counted."""
    monkeypatch.setattr(tfm, "_on_card", lambda *a, **k: True)
    calls = _recorders(monkeypatch, tfm, (
        ("_f32tc_fwd", "f32tc", tfm.flash_mha_fwd_ref),
        ("_f32tc_bwd", "f32tc", tfm.flash_mha_bwd_ref),
        ("_tc_fwd", "tc", tfm.flash_mha_fwd_ref),
        ("_tc_bwd", "tc", tfm.flash_mha_bwd_ref)))
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _inputs((1, 128, 2, 2, 32, True), seed=4))
    fwd0, bwd0 = tfm.flash_mha_fwd.launches, tfm.flash_mha_bwd.launches
    leaves = [x.requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(tfm.flash_mha(*leaves, True), leaves, g)
    assert calls == [(library, "flash_mha_fwd"), (library, "flash_mha_bwd")]
    assert (tfm.flash_mha_fwd.launches - fwd0,
            tfm.flash_mha_bwd.launches - bwd0) == (1, 1)


def test_core_launchers_are_the_cuda_core_templates():
    """The yardstick chip_smoke.py times: flash_gqa.cu's launchers, which
    no path calls in either dtype."""
    assert tfl.core_launchers() == (tfl._launch_fwd, tfl._launch_bwd)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


# chip_smoke.py's fp32 cases, phase 10b (K9/K10) and 11a (K11):
# (B, Tq, Tk, H, H_kv, D, causal)
CARD_CASES = ([(4, 1024, 1024, 8, 2, 64, True),
               (2, 1000, 1000, 8, 2, 64, True), (2, 256, 256, 4, 4, 64, True),
               (2, 256, 256, 4, 2, 64, True), (2, 512, 512, 8, 2, 64, False),
               (2, 128, 128, 4, 2, 32, True),
               (2, 256, 256, 4, 2, 128, False)]
              + [(2, 256, 256, 4, 4, d, c) for d in (32, 64, 128)
                 for c in (True, False)]
              + [(2, 128, 384, 4, 4, 64, True),
                 (2, 384, 128, 4, 4, 64, True),
                 (4, 1024, 1024, 8, 8, 64, True),
                 (4, 1024, 1024, 4, 4, 128, True)])


def _card_inputs(case, gen):
    b, tq, tk, h, hkv, d, _ = case
    return [torch.randn(s, generator=gen, device="cuda")
            for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d),
                      (b, tq, h, d))]


@pytest.mark.cuda
def test_f32tc_kernels_vs_plain_on_card():
    """K9/K10 and K11 in fp32 within 1e-5 (out, lse) and 1e-4 (gradients)
    of their plain versions over chip_smoke.py's fp32 cases."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in CARD_CASES:
        causal = case[-1]
        q, k, v, g = _card_inputs(case, gen)
        out, lse = tfl.flash_gqa_fwd(q, k, v, causal)
        grads = tfl.flash_gqa_bwd(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        r_out, r_lse = tfl.flash_gqa_fwd_ref(q, k, v, causal)
        r_grads = tfl.flash_gqa_bwd_ref(q, k, v, r_out, r_lse, g, causal)
        for x, w, atol in zip((out, lse, *grads), (r_out, r_lse, *r_grads),
                              (FWD_ATOL,) * 2 + (GRAD_ATOL,) * 3):
            torch.testing.assert_close(x, w, rtol=0, atol=atol,
                                       msg=lambda m: f"{case}: {m}")


@pytest.mark.cuda
def test_f32tc_kernels_two_launches_bitwise_equal_on_card():
    """No atomics (the GQA rep sum runs in order): two launches on the
    same inputs give the same bits."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for case in CARD_CASES:
        causal = case[-1]
        q, k, v, g = _card_inputs(case, gen)
        first = tfl.flash_gqa_fwd(q, k, v, causal)
        grads = tfl.flash_gqa_bwd(q, k, v, *first, g, causal)
        again = tfl.flash_gqa_fwd(q, k, v, causal)
        grads2 = tfl.flash_gqa_bwd(q, k, v, *first, g, causal)
        for x, y in zip((*first, *grads), (*again, *grads2)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), case
