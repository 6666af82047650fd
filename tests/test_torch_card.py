"""K7's one-launch kernel and bench.py's headline reduce on the card,
against their plain versions.  Every test here needs an NVIDIA card and
skips without one; the file imports no JAX, so it runs on a machine
without JAX too, where the JAX-importing conftest is skipped:

    python -m pytest tests/test_torch_card.py -q -m cuda --noconftest

* `digest_rows` (``run_rows_kernel``) BITWISE against `digest_rows_ref`
  and the kept two-launch kernel (`core_digest_launcher`): W in {1, 2, 4,
  8}; rows of 1, 15, 16, 17 bytes and of every residue mod 16; bases 1 to
  15 bytes past a 16-byte boundary (sliced buffers, so each row starts
  at another alignment); the verified ring's gathered wire; launches back
  to back and on two streams at once, each stream with its own scratch;
* the APS e5m2 reduce of one ResNet-50 bf16 step's gradients at W = 2,
  faithful and fast: the kernels BITWISE the plain versions;
* K8's SR and stats arms (`qgemm_faithful_sr`, `qgemm_faithful_stats`)
  BITWISE their plain scan over formats, odd and tile-cutting shapes and
  inputs that saturate and underflow, the counts equal, one launch each;
  the stats arm's product bitwise the arm without counting.
"""

import pytest
import torch

from cpd_tpu_torch.ops import qgemm as tqg
from cpd_tpu_torch.ops import quantize as tq

ROW_SIZES = (1, 15, 16, 17, 16 * 40 + 3, 16 * 40 + 9, 100_001)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _equal(a, b, what):
    assert a.dtype == b.dtype == torch.int64, what
    assert torch.equal(a.cpu(), b.cpu()), what


def _rows(w, nbytes, base, gen):
    """(w, nbytes) random bytes whose first byte sits ``base`` bytes past
    a 16-byte boundary."""
    buf = torch.randint(0, 256, (w * nbytes + 16,), generator=gen,
                        dtype=torch.uint8, device="cuda")
    lead = (base - buf.data_ptr()) % 16
    rows = buf[lead:lead + w * nbytes].view(w, nbytes)
    assert rows.data_ptr() % 16 == base
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_digest_rows_one_launch_at_every_alignment_on_card(w):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(w)
    core = tq.core_digest_launcher()
    for nbytes in ROW_SIZES:
        for base in (0, 1, 7, 15):
            rows = _rows(w, nbytes, base, gen)
            before = tq.digest_rows.launches
            got = tq.digest_rows(rows)
            assert tq.digest_rows.launches == before + 1
            what = f"w={w} nbytes={nbytes} base={base}"
            _equal(got, tq.digest_rows_ref(rows), what)
            _equal(got, core(rows), what + " (kept kernel)")


@pytest.mark.cuda
def test_digest_rows_back_to_back_and_on_two_streams_on_card():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [_rows(w, nb, base, gen) for w, nb, base in
             ((4, 996_671, 0), (2, 100_001, 3), (8, 333_333, 9),
              (1, 17, 1), (3, 65_521, 4))]
    back = [tq.digest_rows(r) for r in cases * 3]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    both = []
    for r in cases * 3:
        for s in streams:
            with torch.cuda.stream(s):
                both.append((r, tq.digest_rows(r)))
    torch.cuda.synchronize()
    for r, got in zip(cases * 3, back):
        _equal(got, tq.digest_rows_ref(r), f"back to back {tuple(r.shape)}")
    for r, got in both:
        _equal(got, tq.digest_rows_ref(r), f"two streams {tuple(r.shape)}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["faithful", "fast"])
def test_resnet50_reduce_kernels_match_plain_on_card(mode):
    """One bf16 ResNet-50 step's gradients at W = 2 (batch 2 a rank at
    64 x 64) through the APS e5m2 reduce: K1 (and K3 in faithful mode)
    bitwise the plain versions."""
    _card()
    from cpd_tpu_torch import bench
    from cpd_tpu_torch.parallel.dist import sum_gradients
    from cpd_tpu_torch.parallel.mesh import LocalMesh
    from cpd_tpu_torch.train import as_batch, fp32_numerics, local_gradients

    mesh = LocalMesh(2, "cuda")
    model = bench.headline_step(mode, mesh)[0]
    x, y = bench.headline_batches(2, 2, 64, "cuda", fuse=1)
    x, y = as_batch(x[0], y[0], "cuda")
    with fp32_numerics():
        grads = local_gradients(model, x, y, mesh)[0]
        kw = dict(use_aps=True, grad_exp=5, grad_man=2, mode=mode)
        before = tq.quantize_cast.launches
        got = sum_gradients(grads, mesh, **kw)
        assert tq.quantize_cast.launches - before == 2 * 161 + (
            mode == "fast")
        want = sum_gradients(grads, mesh, fused=False, **kw)
    for r in range(2):
        for i, (a, b) in enumerate(zip(got[r], want[r])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), i


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [(4, 3), (5, 2), (8, 23), (2, 1)])
def test_qgemm_sr_and_stats_arms_match_plain_on_card(fmt):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(sum(fmt))
    key = (12345, 678)
    for m, k, n in [(37, 29, 23), (5, 33, 40), (1, 1, 1), (70, 65, 33)]:
        a = torch.randn((m, k), generator=gen, device="cuda") * 8
        b = torch.randn((k, n), generator=gen, device="cuda")
        a[0] *= 1e4                           # saturates the small formats
        a[-1] *= 2.0 ** -30                   # underflows
        what = f"{fmt} {(m, k, n)}"
        before = (tqg.qgemm_faithful_sr.launches,
                  tqg.qgemm_faithful_stats.launches)
        sr = tqg.qgemm_faithful_sr(a, b, *fmt, key)
        out, counts = tqg.qgemm_faithful_stats(a, b, *fmt)
        sr_out, sr_counts = tqg.qgemm_faithful_stats(a, b, *fmt, key=key)
        torch.cuda.synchronize()
        assert (tqg.qgemm_faithful_sr.launches,
                tqg.qgemm_faithful_stats.launches) == (before[0] + 1,
                                                       before[1] + 2)
        want_sr = tqg.qgemm_faithful_ref(a, b, *fmt, key=key)
        want, want_counts = tqg.qgemm_faithful_ref(a, b, *fmt, stats=True)
        want_sr2, want_sr_counts = tqg.qgemm_faithful_ref(a, b, *fmt,
                                                          key=key,
                                                          stats=True)
        for got, ref in ((sr, want_sr), (sr_out, want_sr2), (out, want),
                         (out, tqg.qgemm_faithful(a, b, *fmt))):
            assert torch.equal(got.view(torch.int32),
                               ref.view(torch.int32)), what
        assert torch.equal(counts, want_counts), (what, counts, want_counts)
        assert torch.equal(sr_counts, want_sr_counts), what
        assert int(counts[3]) == 5 * m * k * n
