"""K9/K10's bf16 tensor-core kernels (`csrc/flash_mha_tc.cu` at rep >= 1)
from the CPU.

The kernels run only on the card, so what can be held here is held here:

* the kernels' rounding order at rep > 1, emulated in torch
  (`_blocked_fwd`, `_blocked_bwd`): an online softmax over 64-key blocks
  with p zeroed by the mask (causal, pad keys past Tk) and rounded to
  bf16 against the *running* max, out = acc / max(l, 1e-30); dq summed
  over 64-key blocks; dk and dv summed per query head over 64-query
  blocks in fp32, then over the rep heads of a kv head in order, and
  rounded to bf16 once.  It is held against JAX's bf16 kernels (the
  forward and LSE by `_flash_gqa_fwd_call` in interpret mode, the
  gradients by `jax.vjp` of `flash_gqa(..., "pallas")`) and against the
  plain K9/K10 within EMU_SHARE of the tolerance the card holds the
  kernels to (rtol = atol = 2e-2), so that any excess on the card is the
  kernels';
* what the wrappers hand the C interface: each argument by its name in
  the source, the (B, Tk, H, D) fp32 scratch at rep > 1 and null at
  rep = 1 (a stand-in library records the call);
* the wrappers' choice of library: bf16 CUDA calls of K9/K10 go to the
  tensor-core kernels, and `core_launchers` stays ``flash_gqa.cu``'s
  templates in both dtypes.

The ``cuda``-marked tests hold the kernels against the plain versions on
the card over chip_smoke.py phase 11a's K9/K10 bf16 cases and check that
two launches are bitwise equal; on the card:
``python -m pytest tests/test_torch_flash_gqa_tc.py -q -m cuda``.
"""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops.flash_gqa import _flash_gqa_fwd_call
from cpd_tpu.ops.flash_gqa import flash_gqa as jflash
from cpd_tpu_torch.ops import build
from cpd_tpu_torch.ops import flash_gqa as tfl

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
EMU_SHARE = 0.5
BLOCK = 64          # the kernels' key (forward, dq) and query (dk/dv) tile
# (B, Tq, Tk, H, H_kv, D, causal): rep 2 and 4, T past the 64-row tiles
# (pad keys, ragged Tq), Tq != Tk either way, causal and not
CASES = [(1, 128, 128, 4, 2, 64, True), (1, 200, 200, 8, 2, 32, True),
         (1, 96, 160, 4, 1, 64, False), (1, 160, 96, 4, 2, 128, True),
         (2, 72, 72, 8, 2, 32, False)]
_SRC = os.path.join(os.path.dirname(build.__file__), "..", "csrc",
                    "flash_mha_tc.cu")


def _inputs(case, seed):
    """numpy-seeded q, k, v and an output cotangent, rounded to bf16, as
    (jax, torch) pairs."""
    b, tq, tk, h, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d),
                        (b, tq, h, d))]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _visible(tq, k0, n, tk, causal):
    """(Tq, n) mask of the keys [k0, k0 + n) each query row sees."""
    qi = torch.arange(tq)[:, None]
    ki = k0 + torch.arange(n)[None, :]
    return (ki < tk) & ((ki <= qi) if causal else True)


def _heads(q, k, v):
    """(B, H, T, D) fp32 q and k, v expanded to the query heads."""
    rep = q.shape[2] // k.shape[2]
    return (q.float().permute(0, 2, 1, 3),
            *(x.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
              for x in (k, v)))


def _blocked_fwd(q, k, v, causal):
    """The tensor-core forward's order: ``(out (B, Tq, H, D) bf16, lse
    (B, H, Tq))``."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qh, kh, vh = _heads(q, k, v)
    m = torch.full((b, h, tq), -1e30)
    l = torch.zeros((b, h, tq))
    acc = torch.zeros((b, h, tq, d))
    for k0 in range(0, tk, BLOCK):
        kt, vt = kh[:, :, k0:k0 + BLOCK], vh[:, :, k0:k0 + BLOCK]
        ok = _visible(tq, k0, kt.shape[2], tk, causal)
        s = torch.where(ok, qh @ kt.transpose(-1, -2) * tfl._scale(d),
                        -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _bf16(p) @ vt
        m = m_new
    den = torch.clamp(l, min=1e-30)
    out = (acc / den[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)
    return out, m + torch.log(den)


def _blocked_bwd(q, k, v, out, lse, dout, causal):
    """The tensor-core backward's order: p and ds per element in fp32,
    rounded to bf16 as operands; dq summed over key blocks; dk and dv per
    query head over query blocks, then over the rep heads in order, each
    gradient rounded once."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = tfl._scale(d)
    qh, kh, vh = _heads(q, k, v)
    do = dout.float().permute(0, 2, 1, 3)
    delta = (out.float() * dout.float()).sum(-1).permute(0, 2, 1)
    ok = _visible(tq, 0, tk, tk, causal)
    p = torch.where(ok, torch.exp((qh @ kh.transpose(-1, -2)) * scale
                                  - lse[..., None]), 0.0)
    ds = (do @ vh.transpose(-1, -2) - delta[..., None]) * p * scale
    p16, ds16 = _bf16(p), _bf16(ds)
    dq = torch.zeros((b, h, tq, d))
    for k0 in range(0, tk, BLOCK):
        cols = slice(k0, k0 + BLOCK)
        dq = dq + ds16[..., cols] @ kh[:, :, cols]
    dkh = torch.zeros((b, h, tk, d))
    dvh = torch.zeros((b, h, tk, d))
    for q0 in range(0, tq, BLOCK):
        rows = slice(q0, q0 + BLOCK)
        dkh = dkh + ds16[:, :, rows].transpose(-1, -2) @ qh[:, :, rows]
        dvh = dvh + p16[:, :, rows].transpose(-1, -2) @ do[:, :, rows]
    dk, dv = (x.reshape(b, hkv, rep, tk, d) for x in (dkh, dvh))
    dk_sum, dv_sum = dk[:, :, 0], dv[:, :, 0]
    for r in range(1, rep):
        dk_sum, dv_sum = dk_sum + dk[:, :, r], dv_sum + dv[:, :, r]
    return tuple(x.permute(0, 2, 1, 3).to(torch.bfloat16)
                 for x in (dq, dk_sum, dv_sum))


def _share(got, want):
    """Largest ``|got - want| / (atol + rtol |want|)`` at BF16_TOL."""
    got = got.double()
    want = torch.from_numpy(np.array(want, dtype=np.float64))
    return float(((got - want).abs()
                  / (BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()))
                 .max())


def _within(got, want, msg):
    assert got.shape == tuple(np.shape(want)), msg
    share = _share(got, want)
    assert share <= EMU_SHARE, f"{msg}: {share:.3f} of the tolerance"


@pytest.mark.parametrize("case", CASES)
def test_blocked_forward_vs_jax_and_plain(case):
    b, tq, _, h, _, _, causal = case
    (jq, jk, jv, _), (q, k, v, _) = _inputs(case, seed=0)
    out, lse = _blocked_fwd(q, k, v, causal)
    jo, jl = _flash_gqa_fwd_call(jq, jk, jv, causal, True)
    jl = np.asarray(jl)[..., :tq].reshape(b, h, tq)
    _within(out, jo.astype(jnp.float32), "out vs JAX")
    _within(lse, jl, "lse vs JAX")
    r_out, r_lse = tfl.flash_gqa_fwd_ref(q, k, v, causal)
    assert out.dtype == r_out.dtype == torch.bfloat16
    _within(out, r_out.float().numpy(), "out vs the plain K9")
    _within(lse, r_lse.numpy(), "lse vs the plain K9")


@pytest.mark.parametrize("case", CASES)
def test_blocked_gradients_vs_jax_vjp_and_plain(case):
    causal = case[-1]
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(case, seed=1)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash(q_, k_, v_, causal, "pallas"),
                     jq, jk, jv)
    want = vjp(jg)
    out, lse = _blocked_fwd(q, k, v, causal)
    got = _blocked_bwd(q, k, v, out, lse, g, causal)
    plain = tfl.flash_gqa_bwd_ref(q, k, v, *tfl.flash_gqa_fwd_ref(
        q, k, v, causal), g, causal)
    for name, x, w, r in zip(("dq", "dk", "dv"), got, want, plain):
        assert x.dtype == r.dtype == torch.bfloat16
        _within(x, w.astype(jnp.float32), f"{name} vs jax.vjp")
        _within(x, r.float().numpy(), f"{name} vs the plain K10")


def _c_params(name: str) -> list:
    """The parameter names of ``extern "C"`` function ``name`` of
    csrc/flash_mha_tc.cu, in order."""
    with open(_SRC) as fh:
        text = fh.read()
    params = re.search(r'extern "C" [\w\s*]+?\b' + name + r"\(([^)]*)\)",
                       text)[1]
    return [re.findall(r"\w+", p)[-1] for p in params.split(",")]


class _Recorder:
    """A stand-in for the loaded library: records each launch's
    arguments by the C parameter names and returns cudaSuccess."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.startswith("flash_tc_"):
            raise AttributeError(name)

        def launch(*args):
            self.calls[name] = dict(zip(_c_params(name), args))
            return 0
        return launch


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' launch path on CPU tensors: the library, the device
    guard and the stream stood in for."""
    lib = _Recorder()
    monkeypatch.setattr(tfl, "tc_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullGuard())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=1234))
    return lib


class _NullGuard:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("h, hkv", [(8, 2), (4, 4)])
def test_wrappers_pass_the_c_interface_its_arguments(recorder, h, hkv):
    """Every argument of the forward and backward launch lands on its C
    parameter: pointers of the tensors, the dimensions with ``hkv``, the
    fp32 scale, the stream; at rep > 1 two (B, Tk, H, D) fp32 scratch
    tensors, at rep = 1 null."""
    b, tq, tk, d = 2, 72, 136, 32
    q, k, v, g = (torch.zeros(s, dtype=torch.bfloat16)
                  for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d),
                            (b, tq, h, d)))
    out, lse = tfl._tc_fwd(q, k, v, True, "fwd")
    f = recorder.calls["flash_tc_fwd_launch"]
    assert list(f) == _c_params("flash_tc_fwd_launch")
    assert (f["q"], f["k"], f["v"], f["out"], f["lse"]) == (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr())
    assert (f["b"], f["tq"], f["tk"], f["h"], f["hkv"], f["d"],
            f["causal"], f["stream"]) == (b, tq, tk, h, hkv, d, 1, 1234)
    assert f["scale"] == tfl._scale(d)
    assert out.shape == q.shape and lse.shape == (b, h, tq)
    parts = []
    real_empty = torch.empty

    def empty(*args, **kw):
        x = real_empty(*args, **kw)
        parts.append(x)
        return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfl.torch, "empty", empty)
        dq, dk, dv = tfl._tc_bwd(q, k, v, out, lse, g, False, "bwd")
    bw = recorder.calls["flash_tc_bwd_launch"]
    assert list(bw) == _c_params("flash_tc_bwd_launch")
    assert (bw["dq"], bw["dk"], bw["dv"]) == (dq.data_ptr(), dk.data_ptr(),
                                              dv.data_ptr())
    assert (bw["b"], bw["tq"], bw["tk"], bw["h"], bw["hkv"], bw["d"],
            bw["causal"], bw["stream"]) == (b, tq, tk, h, hkv, d, 0, 1234)
    assert bw["scale"] == tfl._scale(d)
    assert dk.shape == k.shape and dv.shape == v.shape
    if h > hkv:
        assert [tuple(x.shape) for x in parts] == [(b, tk, h, d)] * 2
        assert all(x.dtype == torch.float32 for x in parts)
        assert (bw["dk_part"], bw["dv_part"]) == tuple(
            x.data_ptr() for x in parts)
    else:
        assert bw["dk_part"] is None and bw["dv_part"] is None


def _recorders(monkeypatch, names):
    calls = []
    for attr, lib, ref in names:
        def launch(*args, lib=lib, ref=ref):
            calls.append((lib, args[-1]))
            return ref(*args[:-1])
        monkeypatch.setattr(tfl, attr, launch)
    return calls


def test_bf16_cuda_calls_launch_the_tensor_core_kernels(monkeypatch):
    """K9/K10 on bf16 CUDA tensors go to flash_mha_tc.cu's kernels
    (`_tc_fwd`, `_tc_bwd`), not flash_gqa.cu's templates, once per call
    and counted (the launchers stood in for: the CPU has no card)."""
    monkeypatch.setattr(tfl, "_on_card", lambda *a, **k: True)
    calls = _recorders(monkeypatch, (
        ("_tc_fwd", "tc", tfl.flash_gqa_fwd_ref),
        ("_tc_bwd", "tc", tfl.flash_gqa_bwd_ref),
        ("_launch_fwd", "core", tfl.flash_gqa_fwd_ref),
        ("_launch_bwd", "core", tfl.flash_gqa_bwd_ref),
        ("_f32tc_fwd", "f32tc", tfl.flash_gqa_fwd_ref),
        ("_f32tc_bwd", "f32tc", tfl.flash_gqa_bwd_ref)))
    _, (q, k, v, g) = _inputs((1, 72, 72, 4, 2, 32, True), seed=3)
    fwd0, bwd0 = tfl.flash_gqa_fwd.launches, tfl.flash_gqa_bwd.launches
    leaves = [x.requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(tfl.flash_gqa(*leaves, True, "pallas"), leaves, g)
    assert calls == [("tc", "flash_gqa_fwd"), ("tc", "flash_gqa_bwd")]
    assert (tfl.flash_gqa_fwd.launches - fwd0,
            tfl.flash_gqa_bwd.launches - bwd0) == (1, 1)


@pytest.mark.parametrize("dtype, code", [(torch.float32, 0),
                                         (torch.bfloat16, 1)])
def test_core_launchers_are_the_templates_in_both_dtypes(monkeypatch, dtype,
                                                         code):
    """`core_launchers` is flash_gqa.cu's forward and backward, and they
    launch its template of the element type asked for (dtype code 0 fp32,
    1 bf16): the yardstick of both tensor-core libraries."""
    seen = []

    def launch(*args):
        seen.append(args)
        return 0

    lib = types.SimpleNamespace(flash_fwd_launch=launch,
                                flash_bwd_launch=launch)
    monkeypatch.setattr(tfl, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullGuard())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    fwd, bwd = tfl.core_launchers()
    assert (fwd, bwd) == (tfl._launch_fwd, tfl._launch_bwd)
    q = torch.zeros((1, 64, 4, 32), dtype=dtype)
    k = torch.zeros((1, 64, 2, 32), dtype=dtype)
    out, lse = fwd(q, k, k, True, "t")
    bwd(q, k, k, out, lse, q, True, "t")
    # (..., h, hkv, d, dtype code, causal, scale, stream)
    assert [a[-4] for a in seen] == [code, code]
    assert [a[-7:-4] for a in seen] == [(4, 2, 32)] * 2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


# chip_smoke.py phase 11a's K9/K10 bf16 cases: (B, Tq, Tk, H, H_kv, D,
# causal)
CARD_CASES = [(4, 1024, 1024, 8, 2, 64, True),
              (2, 256, 256, 4, 4, 64, True), (2, 256, 256, 4, 2, 64, True),
              (2, 256, 256, 8, 2, 64, True), (2, 256, 256, 8, 2, 64, False),
              (2, 256, 256, 8, 2, 32, True), (2, 256, 256, 8, 2, 128, True),
              (2, 256, 256, 4, 2, 128, False),
              (2, 1000, 1000, 8, 2, 64, True),
              (2, 200, 256, 8, 2, 64, True), (2, 200, 256, 4, 1, 128, False),
              (2, 384, 128, 8, 2, 64, True), (2, 384, 128, 8, 2, 32, False),
              (1, 77, 33, 4, 2, 64, True)]


def _card_inputs(case, gen):
    b, tq, tk, h, hkv, d, _ = case
    return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
            for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d),
                      (b, tq, h, d))]


@pytest.mark.cuda
def test_tc_gqa_kernels_vs_plain_on_card():
    """K9/K10 bf16 within 2e-2 of their plain versions, forward (out,
    lse) and backward, over phase 11a's cases."""
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
        for x, w in zip((out, lse, *grads), (r_out, r_lse, *r_grads)):
            torch.testing.assert_close(x.float(), w.float(), **BF16_TOL,
                                       msg=lambda m: f"{case}: {m}")


@pytest.mark.cuda
def test_tc_gqa_kernels_two_launches_bitwise_equal_on_card():
    """No atomics (the rep sum runs in order): two launches on the same
    inputs give the same bits."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for case in CARD_CASES:
        causal = case[-1]
        q, k, v, g = _card_inputs(case, gen)
        first = tfl.flash_gqa_fwd(q, k, v, causal)
        grads = tfl.flash_gqa_bwd(q, k, v, *first, g, causal)
        again = tfl.flash_gqa_fwd(q, k, v, causal)
        grads2 = tfl.flash_gqa_bwd(q, k, v, *first, g, causal)
        for x, y in zip((*first, *grads), (*again, *grads2)):
            assert torch.equal(x.view(bits[x.dtype]),
                               y.view(bits[y.dtype])), case
