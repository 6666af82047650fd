"""K11's bf16 tensor-core kernels (`csrc/flash_mha_tc.cu`) from the CPU.

The kernels run only on the card, so what can be held here is held here:

* the kernels' rounding order, emulated in torch (`_blocked_fwd`,
  `_blocked_bwd`): an online softmax over 64-key blocks with p rounded to
  bf16 against the *running* max and the accumulator and l rescaled by
  alpha in fp32, the gradients summed block by block from bf16 p and ds.
  It is held against JAX ``local_attention(impl="xla")`` and its
  ``jax.grad`` and against the plain K11 (`flash_mha_fwd_ref` /
  `_bwd_ref`) at the tolerance the card holds the kernels to, 2e-2, and
  well inside it (EMU_SHARE of it), so that any excess on the card is the
  kernel's;
* the C interface parsed from the source against the ctypes signatures
  the wrapper sets, and the build registry;
* the wrappers' choice of library by element type (bf16: the tensor-core
  kernels; fp32: the 3xTF32 tensor-core kernels of ``flash_f32_tc.cu``).

The ``cuda``-marked tests hold the kernels against the plain version on
the card and check that two launches are bitwise equal.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops import attention as jatt
from cpd_tpu_torch.ops import build
from cpd_tpu_torch.ops import flash_mha as tfm
from cpd_tpu_torch.ops.flash_gqa import _scale

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# the emulation's largest |x - want| / (atol + rtol |want|): it must use
# at most this share of the card's tolerance
EMU_SHARE = 0.5
BLOCK = 64          # the kernels' key (forward, dq) and query (dk/dv) tile
# (B, Tq, Tk, H, D)
SHAPES = [(2, 256, 256, 4, 64), (1, 128, 384, 2, 128),
          (1, 384, 128, 2, 32)]
_SRC = os.path.join(os.path.dirname(build.__file__), "..", "csrc",
                    "flash_mha_tc.cu")


def _inputs(shape, seed):
    """numpy-seeded bf16 q, k, v and an output cotangent as (jax, torch)
    pairs, both rounded from the same fp32 values."""
    b, tq, tk, h, d = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d),
                        (b, tq, h, d))]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _visible(tq, k0, n, causal):
    """(Tq, n) mask of the keys [k0, k0 + n) each query row sees."""
    qi = torch.arange(tq)[:, None]
    ki = k0 + torch.arange(n)[None, :]
    return ki <= qi if causal else torch.ones((tq, n), dtype=torch.bool)


def _blocked_fwd(q, k, v, causal):
    """The tensor-core forward's order: ``(out (B, Tq, H, D) bf16, lse
    (B, H, Tq))`` from an online softmax over BLOCK-key blocks."""
    b, tq, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, tq), -1e30)
    l = torch.zeros((b, h, tq))
    acc = torch.zeros((b, h, tq, d))
    for k0 in range(0, k.shape[1], BLOCK):
        s = torch.einsum("bqhd,bkhd->bhqk", qf,
                         kf[:, k0:k0 + BLOCK]) * _scale(d)
        s = torch.where(_visible(tq, k0, s.shape[-1], causal), s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", _bf16(p), vf[:, k0:k0 + BLOCK])
        m = m_new
    out = (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return out, m + torch.log(l)


def _blocked_bwd(q, k, v, out, lse, dout, causal):
    """The tensor-core backward's order: p and ds per element in fp32,
    rounded to bf16 as operands; dq summed over key blocks, dk and dv
    over query blocks, in fp32; each gradient rounded once."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = _scale(d)
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    delta = (out.float() * do).sum(-1).permute(0, 2, 1)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.where(_visible(tq, 0, tk, causal),
                    torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = (dp - delta[..., None]) * p * scale
    p16, ds16 = _bf16(p), _bf16(ds)
    dq = torch.zeros((b, h, tq, d))
    for k0 in range(0, tk, BLOCK):
        dq = dq + torch.einsum("bhqk,bkhd->bhqd", ds16[..., k0:k0 + BLOCK],
                               kf[:, k0:k0 + BLOCK])
    dk = torch.zeros((b, h, tk, d))
    dv = torch.zeros((b, h, tk, d))
    for q0 in range(0, tq, BLOCK):
        rows = slice(q0, q0 + BLOCK)
        dk = dk + torch.einsum("bhqk,bqhd->bhkd", ds16[:, :, rows],
                               qf[:, rows])
        dv = dv + torch.einsum("bhqk,bqhd->bhkd", p16[:, :, rows],
                               do[:, rows])
    return tuple(x.permute(0, 2, 1, 3).to(q.dtype) for x in (dq, dk, dv))


def _share(got, want):
    """Largest ``|got - want| / (atol + rtol |want|)`` at BF16_TOL."""
    got, want = got.double(), torch.from_numpy(
        np.array(want, dtype=np.float64))
    return float(((got - want).abs()
                  / (BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()))
                 .max())


def _within(got, want, msg):
    share = _share(got, want)
    assert share <= EMU_SHARE, f"{msg}: {share:.3f} of the tolerance"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_blocked_forward_vs_jax_xla_and_plain(shape, causal):
    (jq, jk, jv, _), (q, k, v, _) = _inputs(shape, seed=0)
    out, lse = _blocked_fwd(q, k, v, causal)
    want = jatt.local_attention(jq, jk, jv, causal, impl="xla")
    _within(out, want, "out vs JAX xla")
    r_out, r_lse = tfm.flash_mha_fwd_ref(q, k, v, causal)
    _within(out, r_out.float(), "out vs the plain K11")
    _within(lse, r_lse, "lse vs the plain K11")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_blocked_gradients_vs_jax_grad_and_plain(shape, causal):
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(shape, seed=1)
    want = jax.grad(lambda q_, k_, v_: (jatt.local_attention(
        q_, k_, v_, causal, impl="xla").astype(jnp.float32)
        * jg.astype(jnp.float32)).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    out, lse = _blocked_fwd(q, k, v, causal)
    got = _blocked_bwd(q, k, v, out, lse, g, causal)
    plain = tfm.flash_mha_bwd_ref(q, k, v, *tfm.flash_mha_fwd_ref(
        q, k, v, causal), g, causal)
    for name, x, w, r in zip(("dq", "dk", "dv"), got, want, plain):
        assert x.dtype == torch.bfloat16 and x.shape == r.shape
        _within(x, w.astype(jnp.float32), f"{name} vs jax.grad")
        _within(x, r.float(), f"{name} vs the plain K11")


def _c_kind(decl: str) -> str:
    """'pointer', 'string', 'int' or 'float' of a C declaration."""
    if "*" in decl:
        return "string" if "char" in decl else "pointer"
    return re.match(r"\s*(?:const\s+)?(int|float)\b", decl).group(1)


def _c_signatures() -> dict:
    """name -> (return kind, parameter kinds) of every ``extern "C"``
    function of csrc/flash_mha_tc.cu."""
    with open(_SRC) as fh:
        text = fh.read()
    return {name: (_c_kind(ret), [_c_kind(p) for p in params.split(",")])
            for ret, name, params in re.findall(
                r'extern "C" ([\w\s*]+?)\s*\b(\w+)\(([^)]*)\)', text)}


_CTYPES_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
                ctypes.c_float: "float", ctypes.c_char_p: "string"}


@pytest.mark.parametrize("name", sorted(tfm.TC_SIGNATURES))
def test_c_interface_matches_ctypes_signatures(name):
    """Each exported function's return and parameter kinds, in order,
    are what the wrapper tells ctypes (a count or kind mismatch would
    cut a pointer or shift every later argument at the first launch)."""
    sigs = _c_signatures()
    assert set(sigs) == set(tfm.TC_SIGNATURES)
    restype, argtypes = tfm.TC_SIGNATURES[name]
    assert sigs[name] == (_CTYPES_KIND[restype],
                          [_CTYPES_KIND[t] for t in argtypes])


def test_build_registry_names_the_source():
    assert build.KERNEL_SOURCES["flash_mha_tc"] == "flash_mha_tc.cu"
    assert os.path.exists(_SRC)
    with open(_SRC) as fh:
        text = fh.read()
    # every product on the bf16 tensor cores, no library
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert "ldmatrix.sync.aligned.m8n8.x4.trans" in text
    assert "cp.async.cg.shared.global" in text
    assert "#include <torch" not in text and "wmma" not in text


@pytest.mark.parametrize("dtype, library", [(torch.bfloat16, "tc"),
                                            (torch.float32, "f32tc")])
def test_cuda_calls_launch_the_library_of_their_dtype(monkeypatch, dtype,
                                                      library):
    """A CUDA call of ``dtype`` goes to the bf16 tensor-core kernels or
    the 3xTF32 tensor-core kernels at rep = 1 (fp32), once per call,
    counted; the launchers are stood in for, since the CPU has no card."""
    calls = []

    def record(lib, ref):
        def launch(*args):
            calls.append((lib, args[-1]))
            return ref(*args[:-1])
        return launch

    monkeypatch.setattr(tfm, "_on_card", lambda *a, **k: True)
    monkeypatch.setattr(tfm, "_tc_fwd", record("tc", tfm.flash_mha_fwd_ref))
    monkeypatch.setattr(tfm, "_tc_bwd", record("tc", tfm.flash_mha_bwd_ref))
    monkeypatch.setattr(tfm, "_f32tc_fwd",
                        record("f32tc", tfm.flash_mha_fwd_ref))
    monkeypatch.setattr(tfm, "_f32tc_bwd",
                        record("f32tc", tfm.flash_mha_bwd_ref))
    _, (q, k, v, g) = _inputs((1, 128, 128, 2, 32), seed=3)
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    fwd0, bwd0 = tfm.flash_mha_fwd.launches, tfm.flash_mha_bwd.launches
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = tfm.flash_mha(*leaves, True)
    torch.autograd.grad(out, leaves, g)
    assert calls == [(library, "flash_mha_fwd"), (library, "flash_mha_bwd")]
    assert (tfm.flash_mha_fwd.launches - fwd0,
            tfm.flash_mha_bwd.launches - bwd0) == (1, 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


# chip_smoke.py phase 11a's bf16 cases: (B, Tq, Tk, H, D, causal)
CARD_CASES = ([(2, 256, 256, 4, d, c) for d in (32, 64, 128)
               for c in (True, False)]
              + [(2, 128, 384, 4, 64, True), (2, 384, 128, 4, 64, True),
                 (4, 1024, 1024, 8, 64, True), (4, 1024, 1024, 4, 128, True)])


def _card_inputs(case, gen):
    b, tq, tk, h, d, _ = case
    return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
            for s in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d),
                      (b, tq, h, d))]


@pytest.mark.cuda
def test_tc_kernels_vs_plain_on_card():
    """The tensor-core K11 within 2e-2 of its plain version, forward (out,
    lse) and backward, over phase 11a's bf16 cases."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in CARD_CASES:
        causal = case[-1]
        q, k, v, g = _card_inputs(case, gen)
        out, lse = tfm.flash_mha_fwd(q, k, v, causal)
        grads = tfm.flash_mha_bwd(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        r_out, r_lse = tfm.flash_mha_fwd_ref(q, k, v, causal)
        r_grads = tfm.flash_mha_bwd_ref(q, k, v, r_out, r_lse, g, causal)
        for x, w in zip((out, lse, *grads), (r_out, r_lse, *r_grads)):
            torch.testing.assert_close(x.float(), w.float(), **BF16_TOL,
                                       msg=lambda m: f"{case}: {m}")


@pytest.mark.cuda
def test_tc_kernels_two_launches_bitwise_equal_on_card():
    """No atomics: two launches on the same inputs give the same bits."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for case in CARD_CASES:
        causal = case[-1]
        q, k, v, g = _card_inputs(case, gen)
        first = tfm.flash_mha_fwd(q, k, v, causal)
        grads = tfm.flash_mha_bwd(q, k, v, *first, g, causal)
        again = tfm.flash_mha_fwd(q, k, v, causal)
        grads2 = tfm.flash_mha_bwd(q, k, v, *first, g, causal)
        bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        for x, y in zip((*first, *grads), (*again, *grads2)):
            assert torch.equal(x.view(bits[x.dtype]),
                               y.view(bits[y.dtype])), case
