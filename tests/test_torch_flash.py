"""The port's attention ops and GQA flash attention vs the JAX package.

The plain flash forward and LSE (K9's plain version) against JAX's
`_flash_gqa_fwd_call` in interpret mode to FWD_ATOL, and the gradients of
`flash_gqa` with ``bwd="pallas"`` (K10's plain version) and
``"chunked"`` against JAX `flash_gqa`'s to GRAD_ATOL — the tolerances the
JAX package holds `flash_gqa` to (tests/test_ops_pallas.py): the same
softmax summed in another order, fp32.  `grouped_query_attention` and
`local_attention` in their XLA and chunked forms to FWD_ATOL.  Shapes:
rep 1, 2 and 4, causal and not, T not a multiple of 128; the bf16 arm
(K9/K10 take q's dtype, as JAX's kernels do) to BF16_TOL.  The kernels
need the card: the ``cuda``-marked test holds them to their plain
versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops import attention as jatt
from cpd_tpu.ops.flash_gqa import _flash_gqa_fwd_call, flash_gqa as jflash
from cpd_tpu_torch.ops import attention as tatt
from cpd_tpu_torch.ops import flash_gqa as tfl

FWD_ATOL = 2e-6
GRAD_ATOL = 2e-5
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# (B, T, H, H_kv, D, causal)
CASES = [(2, 100, 4, 2, 16, True), (1, 130, 4, 1, 8, False),
         (2, 37, 4, 4, 16, True), (1, 72, 8, 2, 8, False)]


def _qkv(b, t, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    return q, k, v


def _close(want, got, atol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("case", CASES)
def test_flash_forward_and_lse_vs_jax(case):
    b, t, h, hkv, d, causal = case
    q, k, v = _qkv(b, t, h, hkv, d)
    jo, jl = _flash_gqa_fwd_call(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, True)
    to, tl = tfl.flash_gqa_fwd(*map(torch.from_numpy, (q, k, v)), causal)
    _close(jo, to, FWD_ATOL, "out")
    _close(np.asarray(jl)[..., :t].reshape(b, h, t), tl, FWD_ATOL, "lse")
    # the autograd entry's forward is the same function
    assert torch.equal(tfl.flash_gqa(*map(torch.from_numpy, (q, k, v)),
                                     causal), to)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bwd", ["pallas", "chunked"])
def test_flash_gradients_vs_jax(case, bwd):
    b, t, h, hkv, d, causal = case
    q, k, v = _qkv(b, t, h, hkv, d, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda q_, k_, v_: (jflash(q_, k_, v_, causal, bwd)
                                        * g).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfl.flash_gqa(*ts, causal, bwd)
    out.backward(torch.from_numpy(g))
    for name, w, x in zip(("dq", "dk", "dv"), want, ts):
        _close(w, x.grad, GRAD_ATOL, f"{bwd} {name}")


def test_flash_bf16_forward_and_gradients_vs_jax():
    """The bf16 arm (q's dtype, as JAX `flash_gqa` takes it): K9's and
    K10's plain versions against JAX's kernels in interpret mode at bf16,
    within BF16_TOL (one bf16 rounding of p, ds or an output apart where
    the sums' order flips it; measured <= 2e-3 at gradients of ~4)."""
    b, t, h, hkv, d, causal = CASES[0]
    q, k, v = _qkv(b, t, h, hkv, d, seed=7)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    jo, jl = _flash_gqa_fwd_call(*jx, causal, True)
    to, tl = tfl.flash_gqa_fwd(*tx, causal)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               **BF16_TOL)
    _close(np.asarray(jl)[..., :t].reshape(b, h, t), tl, FWD_ATOL, "lse")
    want = jax.grad(lambda q_, k_, v_: (jflash(q_, k_, v_, causal, "pallas")
                                        .astype(jnp.float32) * g).sum(),
                    argnums=(0, 1, 2))(*jx)
    leaves = [x.requires_grad_() for x in tx]
    got = torch.autograd.grad(tfl.flash_gqa(*leaves, causal, "pallas"),
                              leaves, torch.from_numpy(g).to(torch.bfloat16))
    for name, w, x in zip(("dq", "dk", "dv"), want, got):
        assert x.dtype == torch.bfloat16
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **BF16_TOL)


def test_flash_backward_plain_matches_autograd_of_forward():
    """K10's plain version == torch autograd through the plain forward
    (an independent oracle of the same gradient)."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(2, 45, 6, 3, 8, seed=3))
    out, lse = tfl.flash_gqa_fwd_ref(q, k, v, True)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(out, (q, k, v), g)
    got = tfl.flash_gqa_bwd_ref(q.detach(), k.detach(), v.detach(),
                                out.detach(), lse, g, True)
    for w, x in zip(want, got):
        _close(w.numpy(), x, GRAD_ATOL)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("case", CASES[:3])
def test_grouped_query_attention_vs_jax(impl, case):
    b, t, h, hkv, d, causal = case
    q, k, v = _qkv(b, t, h, hkv, d, seed=4)
    want = jatt.grouped_query_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        impl=impl)
    got = tatt.grouped_query_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, impl=impl)
    _close(want, got, FWD_ATOL)


def test_local_attention_offsets_and_masked_rows_vs_jax():
    """Query offsets below the keys' leave rows with no key: zero in both
    impls, as in JAX; the chunked scan with k offsets too."""
    q, k, v = _qkv(1, 20, 2, 2, 8, seed=5)
    for impl, q_off, k_off in (("xla", 0, 5), ("chunked", 3, 10),
                               ("xla", 7, 0)):
        want = jatt.local_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, q_off, k_off,
                                    impl=impl)
        got = tatt.local_attention(*map(torch.from_numpy, (q, k, v)), True,
                                   q_off, k_off, impl=impl)
        _close(want, got, FWD_ATOL, f"{impl} {q_off} {k_off}")
    assert not got.isnan().any()


def test_chunked_gradient_vs_xla_gradient():
    """The chunked scan's gradient (checkpointed folds) == the one-shot
    softmax's, over two K/V blocks with a ragged tail."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(1, 150, 4, 2, 8, seed=6))
    g = torch.randn((1, 150, 4, 8), generator=torch.Generator().manual_seed(1))
    grads = []
    for impl, block in (("xla", None), ("chunked", 64)):
        if block is None:
            o = tatt.grouped_query_attention(q, k, v, impl=impl)
        else:
            o = tatt._chunked_attention(q, k, v, True, 0, 0, block=block)
        grads.append(torch.autograd.grad(o, (q, k, v), g))
    for a, b in zip(*grads):
        _close(a.numpy(), b, GRAD_ATOL)


def test_unported_and_invalid_attention_options_raise():
    """MHA flash (K11, tests/test_torch_flash_mha.py) keeps the stock
    kernel's contract: 8 keys are not a multiple of its 128-key block."""
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 4, 4, 8))
    with pytest.raises(ValueError, match="block_q=128"):
        tatt.grouped_query_attention(q, k, v, impl="flash")
    with pytest.raises(ValueError, match="impl"):
        tatt.local_attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="bwd"):
        tfl.flash_gqa(q, k[:, :, :2], v[:, :, :2], True, "xla")
    with pytest.raises(ValueError, match="multiple"):
        tfl.flash_gqa(q, k[:, :, :3], v[:, :, :3], True, "pallas")


@pytest.mark.cuda
def test_flash_kernels_vs_plain_on_card():
    """K9 and K10 on the card against their plain versions: the slice's
    shape, pad keys (T = 1000), rep 1 and 2, non-causal, head_dim 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t, h, hkv, d, causal in [(4, 1024, 8, 2, 64, True),
                                    (2, 1000, 8, 2, 64, True),
                                    (2, 256, 4, 4, 64, True),
                                    (2, 256, 4, 2, 64, False),
                                    (2, 128, 4, 2, 32, True)]:
        q = torch.randn((b, t, h, d), generator=gen, device="cuda")
        k = torch.randn((b, t, hkv, d), generator=gen, device="cuda")
        v = torch.randn((b, t, hkv, d), generator=gen, device="cuda")
        out, lse = tfl.flash_gqa_fwd(q, k, v, causal)
        g = torch.randn(out.shape, generator=gen, device="cuda")
        grads = tfl.flash_gqa_bwd(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        r_out, r_lse = tfl.flash_gqa_fwd_ref(q, k, v, causal)
        r_grads = tfl.flash_gqa_bwd_ref(q, k, v, r_out, r_lse, g, causal)
        assert float((out - r_out).abs().max()) <= 1e-5
        assert float((lse - r_lse).abs().max()) <= 1e-5
        for a, w in zip(grads, r_grads):
            assert float((a - w).abs().max()) <= 1e-4
