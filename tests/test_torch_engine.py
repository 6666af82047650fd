"""The serving slice end to end: the port's `ServeEngine(device="cpu")`
vs the JAX `ServeEngine(fused_attn=True)` on one seeded trace.

Both engines load the same flax parameters and serve the same requests.
At (8, 23) the codec is the lossless fp32 byte split, so the only
difference is fp32 summation order (XLA vs ATen, ~1e-6 in the logits):
the sampled tokens and every counter must be equal and the logged logit
rows within LOGIT_ATOL_E8M23.  At (4, 3) K/V are quantized on append,
and a projection that differs in its last fp32 bit can land on the other
side of an e4m3 rounding boundary (one code step is 2^-3 relative), so
the logits are held to the looser LOGIT_ATOL_E4M3 over the (rid,
position) rows both engines logged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import transformer_lm as jax_lm
from cpd_tpu.serve import Request as JaxRequest
from cpd_tpu.serve import ServeEngine as JaxEngine
from cpd_tpu_torch.interop import load_jax_params
from cpd_tpu_torch.models import transformer_lm as torch_lm
from cpd_tpu_torch.serve import Request, ServeEngine, mixed_trace
from cpd_tpu_torch.serve.engine import _COUNTERS
from test_torch_threads import one_torch_thread  # noqa: F401

VOCAB = 64
ENGINE_KW = dict(n_slots=2, max_seq=32, page_size=8, prefill_chunk=4)
LOGIT_ATOL_E8M23 = 2e-5
LOGIT_ATOL_E4M3 = 5e-2


@pytest.fixture(scope="module")
def models():
    jm = jax_lm(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    tm = torch_lm(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=64, device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


def _trace(seed=0):
    return mixed_trace(4, VOCAB, prompt_lens=(5, 7, 9), max_new=(4, 6),
                       seed=seed)


def _run_port(tm, reqs, **over):
    eng = ServeEngine(tm, device="cpu", record_logits=True,
                      **dict(ENGINE_KW, **over))
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng


def _run_jax(jm, params, reqs, **over):
    eng = JaxEngine(jm, params, record_logits=True,
                    **dict(ENGINE_KW, **over))
    for r in reqs:
        eng.submit(JaxRequest(rid=r.rid, prompt=r.prompt,
                              max_new_tokens=r.max_new_tokens,
                              arrival=r.arrival, eos_id=r.eos_id))
    eng.run_until_drained()
    return eng


def _rows(eng):
    return {(rid, pos): row for rid, pos, row in eng.logits_log}


@pytest.mark.parametrize("fmt,block,atol", [
    ((8, 23), None, LOGIT_ATOL_E8M23),
    ((4, 3), None, LOGIT_ATOL_E4M3),
    ((4, 3), 12, LOGIT_ATOL_E4M3),
])
def test_port_engine_matches_jax_fused_engine(models, fmt, block, atol):
    jm, params, tm = models
    reqs = _trace()
    over = dict(kv_format=fmt, kv_block_size=block, fused_attn=True)
    je = _run_jax(jm, params, reqs, **over)
    te = _run_port(tm, reqs, **over)
    assert te.unresolved() == [] and je.unresolved() == []
    jr, tr = _rows(je), _rows(te)
    common = [k for k in jr if k in tr]
    assert common
    err = max(float(np.abs(jr[k] - tr[k]).max()) for k in common)
    assert err <= atol, f"logits differ by {err} > {atol}"
    if fmt == (8, 23):
        assert dict(te.finished.items()) == dict(je.finished.items())
        assert te.counters == je.counters
        assert tuple(te.counters) == _COUNTERS
        assert [e[:3] for e in te.events] == [e[:3] for e in je.events]


def test_fused_and_plain_read_paths_agree_on_cpu(models):
    """On the CPU the fused wrapper IS the plain version: the two read
    paths serve bitwise the same logits."""
    _, _, tm = models
    reqs = _trace(seed=2)
    a = _run_port(tm, reqs, kv_format=(4, 3), fused_attn=True)
    b = _run_port(tm, reqs, kv_format=(4, 3))
    ra, rb = _rows(a), _rows(b)
    assert ra.keys() == rb.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k].view(np.uint32),
                                      rb[k].view(np.uint32))
    assert a.counters == b.counters


def test_corruption_is_detected_and_repaired(models):
    """A byte flipped in a live page is caught by the next dispatch's
    pre-append check, repaired by recomputation from the token history,
    and the request finishes with the tokens of an undisturbed run."""
    _, _, tm = models
    reqs = [Request(rid=0, prompt=tuple(range(3, 14)), max_new_tokens=6)]
    clean = _run_port(tm, reqs)
    eng = ServeEngine(tm, device="cpu", **ENGINE_KW)
    eng.submit(reqs[0])
    while eng.sched.slots[0].fed < 9:          # page 1 now holds K/V
        eng.step()
    page = eng.sched.slots[0].pages[1]
    eng._pool[0, page, 0, 0, 0, 0, 0] ^= 0xFF
    eng.run_until_drained()
    assert eng.counters["kv_inline_detects"] == 1
    assert eng.counters["kv_repairs"] == 1
    assert eng.counters["kv_pages_corrupt"] == 1
    assert dict(eng.finished.items()) == dict(clean.finished.items())


def test_scrub_finds_free_page_corruption_and_absorbs_it(models):
    _, _, tm = models
    eng = ServeEngine(tm, device="cpu", scrub_every=1, **ENGINE_KW)
    eng._pool[1, 7, 1, 0, 0, 0, 0] ^= 0x01
    assert eng.scrub() == [(1, 7)]
    assert eng.counters["kv_corrupt_free_pages"] == 1
    assert eng.scrub() == []


def test_deadlines_and_queue_bounds(models):
    _, _, tm = models
    eng = ServeEngine(tm, device="cpu", max_queue=1, **ENGINE_KW)
    prompt = tuple(range(1, 9))
    verdicts = [eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=3,
                                   deadline_steps=(1 if i == 1 else None)))
                for i in range(3)]
    assert verdicts == ["accept", "shed", "shed"]
    eng.run_until_drained()
    assert sorted(eng.finished) == [0] and sorted(eng.shed) == [1, 2]
    assert eng.unresolved() == []


@pytest.mark.parametrize("kw", [dict(tp=2), dict(fault_plan=object()),
                                dict(supervisor=object()),
                                dict(prefix_cache=object()),
                                dict(tracer=object()), dict(flight=object()),
                                dict(raw_cache=True)])
def test_unported_options_raise(models, kw):
    _, _, tm = models
    with pytest.raises(NotImplementedError):
        ServeEngine(tm, device="cpu", **ENGINE_KW, **kw)


def test_model_on_another_device_is_refused(models):
    _, _, tm = models
    meta = torch_lm(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=64, device="cpu").to("meta")
    with pytest.raises(ValueError, match="move the model"):
        ServeEngine(meta, device="cpu", **ENGINE_KW)
    assert tm.embed.embedding.device.type == "cpu"
