"""The port's MHA flash attention (K11) vs the JAX package.

The stock Pallas TPU kernel behind JAX ``local_attention(impl="flash")``
does not run off a TPU, even in interpret mode, so the port's plain K11
(`flash_mha_fwd_ref` / `flash_mha_bwd_ref`, through `flash_mha`'s
autograd) is held against JAX ``local_attention(impl="xla")`` and its
``jax.grad`` at the same dtype — the function the JAX package holds the
stock kernel to on a TPU (tests/test_attention_lm.py, rtol = atol = 2e-2
there).  Shapes: (1, 128, 4, 128), the JAX test's own, and (2, 256, 4,
64), causal and not, and Tq = 128 against Tk = 384.  fp32: the same
softmax summed in another order, FWD_TOL forward and GRAD_TOL for dq,
dk, dv.  bf16: BF16_TOL, the JAX test's; p is rounded to bf16 before its
normalisation in K11 and after it in the xla path, one bf16 rounding
apart.  The stock kernel's contract raises ValueError in its words on
every device.  The kernel needs the card: the ``cuda``-marked test holds
it to its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops import attention as jatt
from cpd_tpu_torch.ops import attention as tatt
from cpd_tpu_torch.ops import flash_mha as tfm

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# (B, Tq, Tk, H, D)
SHAPES = [(1, 128, 128, 4, 128), (2, 256, 256, 4, 64), (1, 128, 384, 2, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype, seed):
    """numpy-seeded q, k, v and an output cotangent, as (jax, torch)
    pairs in ``dtype`` (both cast from the same fp32 values, RTNE)."""
    b, tq, tk, h, d = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d),
                        (b, tq, h, d))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               err_msg=msg, **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k11_forward_vs_jax_xla(shape, causal, dtype):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(shape, dtype, seed=0)
    want = jatt.local_attention(jq, jk, jv, causal, impl="xla")
    got = tatt.local_attention(tq, tk, tv, causal, impl="flash")
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, FWD_TOL if dtype == "float32" else BF16_TOL)
    # the lse the backward takes: the masked fp32 logits' logsumexp
    logits = jnp.einsum("bqhd,bkhd->bhqk", jq, jk,
                        preferred_element_type=jnp.float32) * float(
        np.float32(1.0 / float(shape[-1]) ** 0.5))
    if causal:
        logits = jnp.where(jatt._causal_mask(shape[1], shape[2], 0, 0),
                           logits, -jnp.inf)
    _, lse = tfm.flash_mha_fwd(tq, tk, tv, causal)
    _close(lse, jax.nn.logsumexp(logits, axis=-1), FWD_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k11_gradients_vs_jax_grad(shape, causal, dtype):
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, dtype, seed=1)
    want = jax.grad(lambda q, k, v: (jatt.local_attention(
        q, k, v, causal, impl="xla").astype(jnp.float32)
        * jg.astype(jnp.float32)).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.requires_grad_() for x in (tq, tk, tv)]
    out = tfm.flash_mha(*leaves, causal)
    got = torch.autograd.grad(out, leaves, tg)
    for name, w, x in zip(("dq", "dk", "dv"), want, got):
        assert x.dtype == tq.dtype
        _close(x, w, GRAD_TOL if dtype == "float32" else BF16_TOL, name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_k11_backward_matches_autograd_of_forward(causal):
    """K11's plain backward == torch autograd through its plain forward
    (an oracle independent of the JAX package), fp32, Tq != Tk."""
    _, (q, k, v, g) = _inputs((2, 128, 256, 2, 16), "float32", seed=2)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out, lse = tfm.flash_mha_fwd_ref(*leaves, causal)
    want = torch.autograd.grad(out, leaves, g)
    got = tfm.flash_mha_bwd_ref(q.detach(), k.detach(), v.detach(),
                                out.detach(), lse.detach(), g, causal)
    for w, x in zip(want, got):
        _close(x, w.numpy(), GRAD_TOL)


def test_gqa_at_equal_heads_and_local_attention_reach_k11():
    """`grouped_query_attention(impl="flash")` at H == H_kv and
    `local_attention(impl="flash")` are `flash_mha`, bitwise."""
    _, (q, k, v, _) = _inputs((1, 128, 256, 2, 32), "float32", seed=3)
    want = tfm.flash_mha(q, k, v, True)
    assert torch.equal(tatt.grouped_query_attention(q, k, v, impl="flash"),
                       want)
    assert torch.equal(tatt.local_attention(q, k, v, impl="flash"), want)


@pytest.mark.parametrize("case, match", [
    ("offset", "offsets"), ("tk", "divisible by block_k_major=128"),
    ("tq", "block_q=128 should be smaller or equal"),
    ("head_dim", "head_dim=192 should be a multiple of 128"),
    ("backward_tq", "divisible by block_q_major_dkv=128")])
def test_stock_kernel_contract_raises(case, match):
    """What the stock kernel refuses at its default 128-wide blocks, in
    its words: nonzero offsets (the JAX wrapper's own check), Tk not a
    multiple of 128, Tq below 128, head_dim 192, and Tq not a multiple of
    128 in the backward (the forward takes it)."""
    shapes = {"offset": (1, 128, 128, 2, 16), "tk": (1, 128, 200, 2, 16),
              "tq": (1, 64, 128, 2, 16), "head_dim": (1, 128, 128, 1, 192),
              "backward_tq": (1, 200, 128, 2, 16)}
    _, (q, k, v, _) = _inputs(shapes[case], "float32", seed=4)
    with pytest.raises(ValueError, match=match):
        if case == "offset":
            tatt.local_attention(q, k, v, True, q_offset=128, impl="flash")
        elif case == "backward_tq":
            leaves = [x.requires_grad_() for x in (q, k, v)]
            out = tfm.flash_mha(*leaves, True)
            assert out.shape == q.shape
            out.sum().backward()
        else:
            tfm.flash_mha(q, k, v, True)


@pytest.mark.cuda
def test_k11_kernel_vs_plain_on_card():
    """K11 on the card against its plain version, forward (out, lse) and
    backward, fp32 within 1e-5 / 1e-4 and bf16 within BF16_TOL, at head
    dims 32, 64 and 128, causal and not, and Tq != Tk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for b, tq, tk, h, d, causal in [(2, 256, 256, 4, 32, True),
                                        (2, 256, 256, 4, 64, False),
                                        (2, 256, 256, 4, 128, True),
                                        (1, 128, 384, 4, 64, True)]:
            q, g = (torch.randn((b, tq, h, d), generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            k, v = (torch.randn((b, tk, h, d), generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            out, lse = tfm.flash_mha_fwd(q, k, v, causal)
            grads = tfm.flash_mha_bwd(q, k, v, out, lse, g, causal)
            torch.cuda.synchronize()
            r_out, r_lse = tfm.flash_mha_fwd_ref(q, k, v, causal)
            r_grads = tfm.flash_mha_bwd_ref(q, k, v, r_out, r_lse, g, causal)
            fp32 = dtype == torch.float32
            for x, w, atol in ((out, r_out, 1e-5), (lse, r_lse, 1e-5),
                               *((a, b_, 1e-4)
                                 for a, b_ in zip(grads, r_grads))):
                torch.testing.assert_close(
                    x.float(), w.float(), rtol=0 if fp32 else 2e-2,
                    atol=atol if fp32 else 2e-2)
