"""K9-K11 at head dims the kernels are not built for, against JAX.

On the card the wrappers zero-pad a head_dim that is not one of the
kernels' (32, 64, 128, 256, and past 256 the multiples of 128 the
head_dim-split arm takes) up to the next one, run the kernel with the
ORIGINAL head_dim's scale and slice out, dq, dk and dv back
(`flash_gqa._padded_head_dim`), as the JAX kernels pad D to a multiple
of 128.  The padding runs the same way on CPU tensors through the plain
versions, so this file holds the padded path itself, at head_dim 16, 48,
80 and 96, and past 256 at 320 and 512 (K9/K10) and 384 (K11):

* K9/K10 (`flash_gqa_fwd_ref` / `flash_gqa_bwd_ref` padded) against
  JAX's `_flash_gqa_fwd_call` in interpret mode and `jax.vjp` of
  `flash_gqa(bwd="pallas")`, at rep 1 and 4, causal and not: fp32 within
  FWD_ATOL (out, lse) and GRAD_ATOL (dq, dk, dv), bf16 within BF16_TOL;
* K11 (`flash_mha_fwd_ref` / `flash_mha_bwd_ref` padded) against JAX
  ``local_attention(impl="xla")`` and its ``jax.grad`` (the stock Pallas
  kernel does not run off a TPU), as tests/test_torch_flash_mha.py does;
* both against the unpadded plain versions: a padded column adds
  x * 0 = +0 to each dot product, so the two differ by the order of fp32
  sums only, a few ulps (PAD_TOL);
* the wrappers' routing on CUDA tensors, the launchers stood in for
  (the CPU has no card): what the launcher is handed (padded tensors, the
  original scale), what comes back (sliced), which library a head_dim
  takes (past 256 the head_dim-split arm), and no batch limit.

The ``cuda``-marked test holds the kernels to their plain versions at
each new head_dim on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops import attention as jatt
from cpd_tpu.ops.flash_gqa import _flash_gqa_fwd_call, flash_gqa as jflash
from cpd_tpu_torch.ops import flash_gqa as tfl
from cpd_tpu_torch.ops import flash_mha as tfm

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# a padded sum runs in another order than the unpadded one: a few fp32
# ulps of values up to ~10
PAD_TOL = dict(rtol=2e-6, atol=2e-6)
HEAD_DIMS = (16, 48, 80, 96)
# (head_dim, rep, causal): every head_dim at rep 1 and 4, causal and not
# both met at each rep
GQA_CASES = [(d, rep, (i + rep) % 2 == 1)
             for i, d in enumerate(HEAD_DIMS) for rep in (1, 4)]
# past 256: B = 1, H = 4, H_kv = 2, padded to 384 and run at 512 as it is
GQA_CASES += [(320, 2, True), (512, 2, False)]


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _gqa_arrays(d, rep, seed, b=1, t=40, hkv=2):
    h = hkv * rep
    return _arrays(((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d),
                    (b, t, h, d)), seed)


def _err(x, w) -> float:
    return float(np.abs(x.detach().float().numpy()
                        - np.asarray(w, np.float32)).max())


@pytest.mark.parametrize("d, rep, causal", GQA_CASES)
def test_padded_gqa_vs_jax_and_unpadded_plain(d, rep, causal):
    q, k, v, g = _gqa_arrays(d, rep, seed=d + rep)
    b, t, h, _ = q.shape
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tfl._padded_head_dim(tfl.flash_gqa_fwd_ref, (tq, tk, tv),
                                    causal)
    assert out.shape == tq.shape and lse.shape == (b, h, t)
    jo, jl = _flash_gqa_fwd_call(*map(jnp.asarray, (q, k, v)), causal, True)
    assert _err(out, jo) <= FWD_ATOL
    assert _err(lse, np.asarray(jl)[..., :t].reshape(b, h, t)) <= FWD_ATOL
    grads = tfl._padded_head_dim(tfl.flash_gqa_bwd_ref,
                                 (tq, tk, tv, out, lse, tg), causal)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash(q_, k_, v_, causal, "pallas"),
                     *map(jnp.asarray, (q, k, v)))
    for name, x, w in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(g))):
        assert x.shape == w.shape, name
        assert _err(x, w) <= GRAD_ATOL, name
    r_out, r_lse = tfl.flash_gqa_fwd_ref(tq, tk, tv, causal)
    r_grads = tfl.flash_gqa_bwd_ref(tq, tk, tv, r_out, r_lse, tg, causal)
    for x, w in zip((out, lse, *grads), (r_out, r_lse, *r_grads)):
        torch.testing.assert_close(x, w, **PAD_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_gqa_bf16_vs_jax(d):
    """The bf16 arm, rep 4, causal: the padded plain versions against
    JAX's kernels in interpret mode at bf16."""
    q, k, v, g = _gqa_arrays(d, 4, seed=3 * d)
    jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    tg = torch.from_numpy(g).to(torch.bfloat16)
    out, lse = tfl._padded_head_dim(tfl.flash_gqa_fwd_ref, tuple(tx), True)
    assert out.dtype == torch.bfloat16 and out.shape == tx[0].shape
    jo, _ = _flash_gqa_fwd_call(*jx, True, True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jo, np.float32), **BF16_TOL)
    grads = tfl._padded_head_dim(tfl.flash_gqa_bwd_ref,
                                 (*tx, out, lse, tg), True)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash(q_, k_, v_, True, "pallas"),
                     *jx)
    for name, x, w in zip(("dq", "dk", "dv"), grads,
                          vjp(jnp.asarray(g).astype(jnp.bfloat16))):
        assert x.dtype == torch.bfloat16, name
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS + (384,))
def test_padded_mha_vs_jax_xla(d, dtype):
    """K11 padded, against JAX xla attention and its gradient (fp32:
    FWD_ATOL / GRAD_ATOL; bf16: BF16_TOL), causal at 16 and 80, not at 48,
    96 and 384 (the head_dim-split arm's, held through the plain K11: the
    stock Pallas kernel does not run off a TPU); and against the unpadded
    plain K11."""
    causal = d in (16, 80)
    q, k, v, g = _arrays([(1, 128, 2, d)] * 4, seed=d)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = [jnp.asarray(x).astype(jdt) for x in (q, k, v, g)]
    tx = [torch.from_numpy(x).to(tdt) for x in (q, k, v, g)]
    out, lse = tfl._padded_head_dim(tfm.flash_mha_fwd_ref, tuple(tx[:3]),
                                    causal)
    grads = tfl._padded_head_dim(tfm.flash_mha_bwd_ref,
                                 (*tx[:3], out, lse, tx[3]), causal)
    want, vjp = jax.vjp(
        lambda q_, k_, v_: jatt.local_attention(q_, k_, v_, causal,
                                                impl="xla"), *jx[:3])
    fp32 = dtype == "float32"
    tols = ([dict(rtol=0, atol=FWD_ATOL)] + [dict(rtol=0, atol=GRAD_ATOL)] * 3
            if fp32 else [BF16_TOL] * 4)
    for name, x, w, tol in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (want, *vjp(jx[3])), tols):
        assert x.dtype == tdt and x.shape == tx[0].shape, name
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **tol)
    r_out, r_lse = tfm.flash_mha_fwd_ref(*tx[:3], causal)
    r_grads = tfm.flash_mha_bwd_ref(*tx[:3], r_out, r_lse, tx[3], causal)
    for x, w in zip((out, lse, *grads), (r_out, r_lse, *r_grads)):
        torch.testing.assert_close(x.float(), w.float(),
                                   **(PAD_TOL if fp32 else BF16_TOL))


def test_kernel_head_dim_and_the_raise_past_256():
    """Up to 256 the kernels' own head dims; past 256 no raise since the
    head_dim-split arm: the JAX kernel's next multiple of 128."""
    assert [tfl.kernel_head_dim(d) for d in (1, 16, 32, 33, 48, 64, 80, 96,
                                             128, 129, 200, 256)] == [
        32, 32, 32, 64, 64, 64, 128, 128, 128, 256, 256, 256]
    assert [tfl.kernel_head_dim(d) for d in (257, 320, 384, 512, 1000)] == [
        384, 384, 384, 512, 1024]


def _stand_ins(monkeypatch, module, names):
    """Each launcher named records (library, the shapes and scale it was
    handed) and runs the plain version of its direction at that scale."""
    calls = []
    for attr, lib, ref in names:
        def launch(*args, lib=lib, ref=ref, scale=None):
            calls.append((lib, [tuple(a.shape) for a in args
                                if isinstance(a, torch.Tensor)], scale))
            return ref(*args[:-1], scale=scale)
        monkeypatch.setattr(module, attr, launch)
    return calls


GQA_STAND_INS = (("_f32tc_fwd", "f32tc", tfl.flash_gqa_fwd_ref),
                 ("_f32tc_bwd", "f32tc", tfl.flash_gqa_bwd_ref),
                 ("_tc_fwd", "tc", tfl.flash_gqa_fwd_ref),
                 ("_tc_bwd", "tc", tfl.flash_gqa_bwd_ref),
                 ("_launch_fwd", "core", tfl.flash_gqa_fwd_ref),
                 ("_launch_bwd", "core", tfl.flash_gqa_bwd_ref),
                 ("_split_fwd", "split", tfl.flash_gqa_fwd_ref),
                 ("_split_bwd", "split", tfl.flash_gqa_bwd_ref))


@pytest.mark.parametrize("dtype, d, library, d_p", [
    (torch.float32, 48, "f32tc", 64), (torch.bfloat16, 80, "tc", 128),
    (torch.float32, 200, "core", 256), (torch.bfloat16, 256, "core", 256),
    (torch.float32, 320, "split", 384), (torch.bfloat16, 512, "split", 512)])
def test_cuda_calls_pad_to_the_kernel_and_slice_back(monkeypatch, dtype, d,
                                                     library, d_p):
    """K9/K10 on CUDA tensors of head_dim ``d``: the launcher of ``d_p``
    gets zero-padded (B, T, heads, d_p) tensors and the scale of ``d``
    (None where d is the kernel's own), and the outputs come back at
    ``d``, equal to the unpadded plain versions."""
    monkeypatch.setattr(tfl, "_on_card", lambda *a, **k: True)
    calls = _stand_ins(monkeypatch, tfl, GQA_STAND_INS)
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _gqa_arrays(d, 2, seed=5, t=24))
    out, lse = tfl.flash_gqa_fwd(q, k, v, True)
    grads = tfl.flash_gqa_bwd(q, k, v, out, lse, g, True)
    scale = None if d == d_p else tfl._scale(d)
    assert [(c[0], c[2]) for c in calls] == [(library, scale)] * 2
    assert calls[0][1] == [(1, 24, 4, d_p), (1, 24, 2, d_p), (1, 24, 2, d_p)]
    assert calls[1][1][:4] == [(1, 24, 4, d_p), (1, 24, 2, d_p),
                               (1, 24, 2, d_p), (1, 24, 4, d_p)]
    assert calls[1][1][4:] == [(1, 4, 24), (1, 24, 4, d_p)]
    r_out, r_lse = tfl.flash_gqa_fwd_ref(q, k, v, True)
    r_grads = tfl.flash_gqa_bwd_ref(q, k, v, r_out, r_lse, g, True)
    for x, w in zip((out, lse, *grads), (r_out, r_lse, *r_grads)):
        assert x.shape == w.shape and x.dtype == w.dtype
        assert x.is_contiguous() or d == d_p   # a slice is made contiguous
        torch.testing.assert_close(x.float(), w.float(),
                                   **(PAD_TOL if dtype == torch.float32
                                      else BF16_TOL))


@pytest.mark.parametrize("dtype, d, library", [
    (torch.float32, 96, "f32tc"), (torch.bfloat16, 16, "tc"),
    (torch.float32, 256, "core"), (torch.bfloat16, 256, "core"),
    (torch.float32, 384, "split"), (torch.bfloat16, 512, "split")])
def test_mha_cuda_calls_take_the_library_of_their_head_dim(monkeypatch,
                                                           dtype, d,
                                                           library):
    """K11 on CUDA tensors: up to 128 the tensor-core library of the
    dtype, padded; at 256 flash_gqa.cu's templates; at 384 and 512 its
    head_dim-split arm; D = 200 breaks the stock kernel's contract (a
    multiple of 128 past 128) on every device."""
    monkeypatch.setattr(tfm, "_on_card", lambda *a, **k: True)
    calls = _stand_ins(monkeypatch, tfm, (
        ("_f32tc_fwd", "f32tc", tfm.flash_mha_fwd_ref),
        ("_f32tc_bwd", "f32tc", tfm.flash_mha_bwd_ref),
        ("_tc_fwd", "tc", tfm.flash_mha_fwd_ref),
        ("_tc_bwd", "tc", tfm.flash_mha_bwd_ref),
        ("_launch_fwd", "core", tfm.flash_mha_fwd_ref),
        ("_launch_bwd", "core", tfm.flash_mha_bwd_ref),
        ("_split_fwd", "split", tfm.flash_mha_fwd_ref),
        ("_split_bwd", "split", tfm.flash_mha_bwd_ref)))
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _arrays([(1, 128, 2, d)] * 4, seed=6))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(tfm.flash_mha(*leaves, True), leaves, g)
    assert [c[0] for c in calls] == [library] * 2
    d_p = tfl.kernel_head_dim(d)
    assert calls[0][1][0] == (1, 128, 2, d_p)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfm.flash_mha_fwd(*(torch.zeros((1, 128, 2, 200), dtype=dtype)
                            for _ in range(3)))


def test_no_batch_limit_and_head_dim_past_256_raises(monkeypatch):
    """B * H past the grid's 65535 reaches the launcher (it runs the batch
    in chunks); head_dim 320, which raised on the card before the
    head_dim-split arm, reaches that arm zero-padded to 384, and runs on
    the CPU through the plain version."""
    monkeypatch.setattr(tfl, "_on_card", lambda *a, **k: True)
    seen = []
    monkeypatch.setattr(tfl, "_tc_fwd", lambda q, *a, **kw: seen.append(
        q.shape) or (q, q[..., 0].transpose(1, 2)))
    q = torch.zeros((4100, 1, 16, 32), dtype=torch.bfloat16)
    kv = torch.zeros((4100, 1, 16, 32), dtype=torch.bfloat16)
    tfl.flash_gqa_fwd(q, kv, kv, True)
    assert seen == [q.shape]
    x = torch.zeros((1, 8, 2, 320))
    monkeypatch.setattr(tfl, "_split_fwd", lambda q, *a, **kw: seen.append(
        q.shape) or (q, q[..., 0].transpose(1, 2)))
    assert tfl.flash_gqa_fwd(x, x, x, True)[0].shape == x.shape
    assert seen[-1] == (1, 8, 2, 384)
    monkeypatch.undo()
    assert tfl.flash_gqa_fwd(x, x, x, True)[0].shape == x.shape


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


# (B, T, H, H_kv, D, causal) at the padded head dims and at 256
CARD_CASES = [(2, 200, 4, 2, d, c) for d in (16, 48, 80, 96, 256, 320, 512)
              for c in (True, False)] + [(2, 128, 4, 4, d, True)
                                         for d in (256, 384, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_new_head_dims_vs_plain_on_card(dtype):
    """K9/K10 at each new head_dim within 1e-5 / 1e-4 (fp32) or 2e-2
    (bf16) of their plain versions (320 and 512 on the head_dim-split
    arm), and K11 at D = 256, 384 and 512; two launches bitwise
    equal."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    for b, t, h, hkv, d, causal in CARD_CASES:
        q, g = (torch.randn((b, t, h, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, t, hkv, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        fwd, bwd, fwd_ref, bwd_ref = (
            (tfm.flash_mha_fwd, tfm.flash_mha_bwd, tfm.flash_mha_fwd_ref,
             tfm.flash_mha_bwd_ref) if h == hkv else
            (tfl.flash_gqa_fwd, tfl.flash_gqa_bwd, tfl.flash_gqa_fwd_ref,
             tfl.flash_gqa_bwd_ref))
        out, lse = fwd(q, k, v, causal)
        grads = bwd(q, k, v, out, lse, g, causal)
        again = (*fwd(q, k, v, causal), *bwd(q, k, v, out, lse, g, causal))
        torch.cuda.synchronize()
        for x, y in zip((out, lse, *grads), again):
            assert torch.equal(x, y), (d, causal)
        r_out, r_lse = fwd_ref(q, k, v, causal)
        r_grads = bwd_ref(q, k, v, r_out, r_lse, g, causal)
        tols = ([dict(rtol=0, atol=FWD_ATOL)] * 2
                + [dict(rtol=0, atol=GRAD_ATOL)] * 3
                if dtype == torch.float32 else [BF16_TOL] * 5)
        for x, w, tol in zip((out, lse, *grads), (r_out, r_lse, *r_grads),
                             tols):
            torch.testing.assert_close(x.float(), w.float(), **tol,
                                       msg=lambda m: f"{(d, causal)}: {m}")
