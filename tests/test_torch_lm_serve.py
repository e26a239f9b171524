"""Port parity: the LM serving engine (``repro_torch.serve.engine``) and its
CLI (``repro_torch.launch.serve``) against the reference's on the CPU.

Every claim of the reference's ``tests/test_serve.py`` about the engine is
run by the reference's ``ServeEngine`` and the port's on the same prompts
and the same f32 weights (the reference's, carried across with
``params_from_arrays``): the generated tokens are equal token for token and
equal the port's single-request greedy loop; slot reuse, priority
admission, the admission-timeout shed and the ``stats()`` counts agree.
On the engines' default bf16 caches under f32 weights (the CLI's dtypes)
both engines' tokens equal the reference's loop up to its first near-tie.
One engine tick's spans, events and counters equal the reference engine's.
The port's CLI runs with ``--device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import get_bundle as jget_bundle
from repro.models import lm as JLM
from repro.obs import METRICS as JMETRICS
from repro.obs import TRACER as JTRACER
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.dist.sharding import make_plan
from repro_torch.launch import serve as serve_cli
from repro_torch.models import get_bundle
from repro_torch.models import lm as LM
from repro_torch.obs import METRICS, TRACER
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.router import QUEUE_DEPTH_METRIC, TIER_BATCH

KEY = jax.random.PRNGKey(0)
COUNT_KEYS = ("requests", "tokens", "ticks", "shed")


@pytest.fixture(scope="module")
def served():
    jcfg = jreduced(jget_config("olmo-1b"))
    cfg = reduced(get_config("olmo-1b"))
    jp = jget_bundle(jcfg).init(jcfg, KEY, dtype=jnp.float32)
    p = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, cfg, jp, p


@pytest.fixture(autouse=True)
def _clean_planes():
    for tracer, metrics in ((TRACER, METRICS), (JTRACER, JMETRICS)):
        tracer.disable()
        tracer.reset()
        metrics.reset()
    yield
    for tracer, metrics in ((TRACER, METRICS), (JTRACER, JMETRICS)):
        tracer.disable()
        tracer.reset()
        metrics.reset()


def _engines(served, *, bf16=False, **kw):
    """The reference's engine and the port's: f32 caches, or with ``bf16``
    the engines' default bf16 caches (the weights stay f32, as the CLI's)."""
    jcfg, cfg, jp, p = served
    if bf16:
        return (JServeEngine(jcfg, jp, **kw),
                ServeEngine(cfg, p, device="cpu", **kw))
    return (JServeEngine(jcfg, jp, dtype=jnp.float32, **kw),
            ServeEngine(cfg, p, dtype=torch.float32, device="cpu", **kw))


def _drain(served, script, **kw):
    """Submit ``script`` ([(prompt, submit kwargs)]) to the reference's
    engine and the port's and drain both: [(engine, uids, done)] for each."""
    out = []
    for engine in _engines(served, **kw):
        uids = [engine.submit(prompt, **skw) for prompt, skw in script]
        done = engine.run_until_drained()
        out.append((engine, uids, done))
    return out


def _both(served, script, **kw):
    """``_drain``, and check that the two engines finished the same requests
    in the same order with the same tokens and flags."""
    (jengine, juids, jdone), (engine, uids, done) = _drain(served, script,
                                                           **kw)
    assert uids == juids
    assert [(r.uid, r.tokens, r.shed, r.priority) for r in done] == \
        [(r.uid, r.tokens, r.shed, r.priority) for r in jdone]
    jst, st = jengine.stats(), engine.stats()
    assert set(st) == set(jst)
    assert {k: st[k] for k in COUNT_KEYS} == {k: jst[k] for k in COUNT_KEYS}
    return engine, uids, done


def _single_request(cfg, params, prompt, bucket, max_new):
    """The port's single-request greedy loop with the same left-pad
    bucketing (``tests/test_serve.py::_reference_generate``)."""
    bundle, splan = get_bundle(cfg), make_plan(cfg, None)
    toks = np.zeros((1, bucket), np.int64)
    toks[0, bucket - len(prompt):] = prompt
    logits, caches = LM.lm_prefill(cfg, params, torch.from_numpy(toks),
                                   splan=splan, ctx=96)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(max_new - 1):
        cur = torch.tensor([[out[-1]]])
        logits, caches = bundle.decode(cfg, params, caches, cur, splan)
        out.append(int(torch.argmax(logits[0])))
    return out


def test_engine_matches_reference(served):
    _, cfg, _, p = served
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(4)]   # 4 requests through 2 slots
    _, uids, done = _both(served, [(q, {"max_new_tokens": 6})
                                   for q in prompts],
                          slots=2, max_ctx=96, prompt_buckets=(16,))
    assert len(done) == 4
    by_uid = {r.uid: r for r in done}
    for uid, q in zip(uids, prompts):
        assert by_uid[uid].tokens == _single_request(cfg, p, q, 16, 6)


def _reference_bf16_loop(jcfg, jp, prompt, bucket, max_new, max_ctx):
    """The reference's single-request greedy loop on the engine's default
    caches: the f32 prefill cache cast to bf16 at ``max_ctx`` positions and
    a ``[1]`` slot index, as ``_insert_fn`` leaves one slot.  Returns the
    tokens and each step's gap between its two largest logits."""
    toks = np.zeros((1, bucket), np.int32)
    toks[0, bucket - len(prompt):] = prompt
    logits, caches = JLM.lm_prefill(jcfg, jp, jnp.asarray(toks), ctx=max_ctx)
    caches = {n: ({k: t.astype(jnp.bfloat16) for k, t in c.items()}
                  if n != "index" else jnp.full((1,), bucket, jnp.int32))
              for n, c in caches.items()}
    out, gaps = [], []
    for step in range(max_new):
        if step:
            logits, caches = JLM.lm_decode(jcfg, jp, caches,
                                           jnp.asarray([[out[-1]]]))
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        out.append(int(np.argmax(np.asarray(logits[0]))))
        gaps.append(float(top2[1] - top2[0]))
    return out, gaps


def test_engine_matches_reference_on_bf16_caches(served):
    """The engines' default: f32 weights (the CLI's) against bf16 caches.
    Both engines' tokens equal the reference's loop on bf16 caches token for
    token up to that loop's first near-tie (its two largest logits within
    ``TIE``): past one, a last-bit difference may rightly pick the other."""
    jcfg, cfg, jp, _ = served
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(4)]   # 4 requests through 2 slots
    (jengine, juids, jdone), (engine, uids, done) = _drain(
        served, [(q, {"max_new_tokens": 6}) for q in prompts], bf16=True,
        slots=2, max_ctx=96, prompt_buckets=(16,))
    for e in (jengine, engine):
        assert e.caches["p0"]["k"].dtype.itemsize == 2          # bf16
    assert uids == juids and len(done) == len(jdone) == 4
    TIE = 1e-3
    mine = {r.uid: r.tokens for r in done}
    ref = {r.uid: r.tokens for r in jdone}
    compared = 0
    for uid, q in zip(uids, prompts):
        want, gaps = _reference_bf16_loop(jcfg, jp, q, 16, 6, 96)
        n = next((i + 1 for i, g in enumerate(gaps) if g < TIE), len(want))
        assert mine[uid][:n] == ref[uid][:n] == want[:n], uid
        compared += n
    assert compared >= 12, compared


def test_engine_slot_reuse(served):
    _, cfg, _, _ = served
    rng = np.random.default_rng(1)
    engine, _, done = _both(
        served, [(rng.integers(0, cfg.vocab_size, 6), {"max_new_tokens": 3})
                 for _ in range(5)],
        slots=2, max_ctx=64, prompt_buckets=(8,))
    assert len(done) == 5
    s = engine.stats()
    assert s["requests"] == 5 and s["tokens"] == 15


def test_engine_priority_admission(served):
    _, cfg, _, _ = served
    rng = np.random.default_rng(2)
    script = [(rng.integers(0, cfg.vocab_size, 4),
               {"max_new_tokens": 2, "priority": pr}) for pr in (1, 1, 0)]
    _, uids, done = _both(served, script, slots=1, max_ctx=64,
                          prompt_buckets=(8,))
    order = [r.uid for r in done]
    assert order.index(uids[2]) < order.index(uids[1])


def test_admission_timeout_sheds_to_batch_tier(served):
    _, cfg, _, _ = served
    rng = np.random.default_rng(3)
    script = [(rng.integers(0, cfg.vocab_size, 4), kw) for kw in (
        {"max_new_tokens": 4, "priority": 1},
        {"max_new_tokens": 2, "priority": 1},
        # interactive, but its admission budget is spent on arrival
        {"max_new_tokens": 2, "priority": 0, "timeout_s": 0.0})]
    engine, (uid1, uid2, uid3), done = _both(served, script, slots=1,
                                             max_ctx=64, prompt_buckets=(8,))
    order = [r.uid for r in done]
    assert order.index(uid3) > order.index(uid1)
    assert order.index(uid3) > order.index(uid2)
    req3 = next(r for r in done if r.uid == uid3)
    assert req3.shed and req3.priority == TIER_BATCH
    assert engine.stats()["shed"] == 1
    assert len(done) == 3 and len(req3.tokens) == 2
    assert engine.metrics.counter("serve.shed").value == 1


def test_stats_percentiles_from_histograms(served):
    _, cfg, _, _ = served
    rng = np.random.default_rng(5)
    engine, _, done = _both(
        served, [(rng.integers(0, cfg.vocab_size, 4), {"max_new_tokens": 3})
                 for _ in range(4)],
        slots=2, max_ctx=64, prompt_buckets=(8,))
    st = engine.stats()
    assert st["requests"] == len(done) == 4
    assert engine.metrics.counter("serve.requests").value == 4
    lat = sorted(r.finished_at - r.submitted_at for r in done)
    assert 0.0 <= st["p50_queue_wait_s"] <= st["p99_queue_wait_s"]
    assert 0.0 < st["p50_latency_s"] <= st["p99_latency_s"]
    assert lat[0] <= st["p50_latency_s"] <= lat[-1]
    assert st["p99_latency_s"] <= lat[-1]
    h = engine.metrics.histogram("serve.e2e_latency_s")
    assert h.count == 4 and h.summary()["p99"] == st["p99_latency_s"]


def test_one_tick_spans_and_counters_match_reference(served):
    """One traced tick: the shed event, one ``serve.prefill`` span a slot
    filled and one ``serve.execute``, with the reference's attributes, and
    the same per-engine and process-global counters."""
    _, cfg, _, _ = served
    rng = np.random.default_rng(6)
    script = [(rng.integers(0, cfg.vocab_size, 5), kw) for kw in (
        {"max_new_tokens": 3, "priority": 1},
        {"max_new_tokens": 3, "priority": 0, "timeout_s": 0.0},
        {"max_new_tokens": 3, "priority": 1})]
    seen = []
    for engine, tracer, metrics in zip(_engines(served, slots=2, max_ctx=64,
                                                prompt_buckets=(8,)),
                                       (JTRACER, TRACER),
                                       (JMETRICS, METRICS)):
        for prompt, kw in script:
            engine.submit(prompt, **kw)
        tracer.enable()
        try:
            engine.step()
        finally:
            tracer.disable()
        seen.append(dict(
            spans=[(s.name, s.attrs, [(e.name, e.attrs) for e in s.events])
                   for s in tracer.finished()],
            orphans=[(e.name, e.attrs) for e in tracer._orphan_events],
            engine=engine.metrics.counter_values(),
            depth=metrics.counter(QUEUE_DEPTH_METRIC).value))
    want, got = seen
    assert got == want
    assert [n for n, _, _ in got["spans"]] == \
        ["serve.prefill", "serve.prefill", "serve.execute"]
    assert got["orphans"] == [("serve.shed", {"uid": 2})]
    assert got["engine"] == {"serve.requests": 3, "serve.shed": 1}
    assert got["depth"] == 1


def test_serve_cli_on_the_cpu(capsys):
    stats = serve_cli.main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    budgets = []
    for _ in range(12):                # the CLI's own draws, in its order
        plen = int(rng.integers(4, 48))
        budgets.append(int(rng.integers(4, 24)))
        rng.integers(0, 512, plen)
    assert stats["requests"] == 12
    assert stats["tier0_interactive"] + stats["tier1_batch"] == 12
    assert '"requests": 12' in capsys.readouterr().out
    assert stats["tokens"] == sum(budgets)


def test_engine_device_checks(served):
    _, cfg, _, p = served
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(cfg, p)                      # the card by default
    with pytest.raises(ValueError, match="params lie on"):
        ServeEngine(cfg, p, device="meta")
    moe = reduced(get_config("llama4-scout-17b-a16e"))
    with pytest.raises(NotImplementedError, match="item 13b"):
        ServeEngine(moe, p, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(reduced(get_config("seamless-m4t-large-v2")), p,
                    device="cpu")
