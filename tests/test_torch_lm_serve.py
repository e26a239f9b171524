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

The MoE, SSD and hybrid families (llama4-scout, llama4-maverick, mamba2,
zamba2, each at two blocks) run through both engines too: token for token
on f32 caches, and on bf16 caches up to the first near-tie of the port's
single-request loop; a slot reused over SSD caches leaks nothing of its
previous request.  Both engines keep the reference's ``max_new_tokens=1``
behaviour (the request never finishes).
"""

import dataclasses
import functools

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
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(reduced(get_config("seamless-m4t-large-v2")), p,
                    device="cpu")


def test_max_new_tokens_one_never_finishes_in_either_engine(served):
    """A copied reference defect, kept (``docs/torch_lm.md``): admission
    leaves ``max_new_tokens - 1 = 0`` tokens to go, the tick skips a slot
    with none left, and only the tick finishes a request, so a request of
    one new token holds its slot until ``max_ticks``."""
    _, cfg, _, _ = served
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 5) for _ in range(2)]
    seen = []
    for engine in _engines(served, slots=1, max_ctx=64, prompt_buckets=(8,)):
        for q in prompts:
            engine.submit(q, max_new_tokens=1)
        done = engine.run_until_drained(max_ticks=50)
        (req,) = engine._active.values()
        seen.append((len(done), len(engine._active), len(engine._queue),
                     req.uid, list(req.tokens)))
    assert seen[0] == seen[1]
    assert seen[1][:4] == (0, 1, 1, 1) and len(seen[1][4]) == 1


# -- the MoE, SSD and hybrid families ------------------------------------------

FAMILIES = ["mamba2-2.7b", "zamba2-2.7b", "llama4-scout-17b-a16e",
            "llama4-maverick-400b-a17b"]
TWO_BLOCKS = {"zamba2-2.7b": 12, "llama4-scout-17b-a16e": 8,
              "llama4-maverick-400b-a17b": 8}


@functools.lru_cache(maxsize=None)
def _family(arch: str):
    """(reference config, port config, reference f32 weights, the port's
    copy) at two blocks; the LoRA ``b`` and the SSD's ``A_log`` /
    ``dt_bias`` / ``D`` drawn at random so that they matter."""
    changes = {"num_layers": TWO_BLOCKS[arch]} if arch in TWO_BLOCKS else {}
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    assert cfg.num_blocks == 2
    tree = jax.tree_util.tree_map(
        np.asarray, jget_bundle(jcfg).init(jcfg, KEY, dtype=jnp.float32))
    r = np.random.default_rng(len(arch))

    def live(node, name=""):
        if isinstance(node, dict):
            return {k: live(v, k) for k, v in node.items()}
        if name in ("b", "A_log", "dt_bias"):
            return r.normal(0.0, 0.1, node.shape).astype(node.dtype)
        if name == "D":
            return r.normal(1.0, 0.3, node.shape).astype(node.dtype)
        return node

    tree = live(tree)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            LM.params_from_arrays(tree, device="cpu"))


def _port_loop(cfg, params, prompt, bucket, max_new, max_ctx, dtype):
    """The port's single-request greedy loop on the engine's caches: the
    prefill's cache copied into ``init_caches(1, max_ctx, dtype)`` with a
    ``[1]`` index, as ``_insert_fn`` leaves one slot.  Returns the tokens
    and each step's gap between its two largest logits."""
    toks = np.zeros((1, bucket), np.int64)
    toks[0, bucket - len(prompt):] = prompt
    logits, cache1 = LM.lm_prefill(cfg, params, torch.from_numpy(toks),
                                   ctx=max_ctx)
    caches = LM.init_caches(cfg, 1, max_ctx, dtype=dtype, device="cpu")
    for name, c in cache1.items():
        if name != "index":
            for leaf, t in c.items():
                caches[name][leaf].copy_(t)
    caches["index"] = torch.tensor([bucket], dtype=torch.int32)
    out, gaps = [], []
    for step in range(max_new):
        if step:
            logits, caches = LM.lm_decode(cfg, params, caches,
                                          torch.tensor([[out[-1]]]))
        top2 = torch.topk(logits[0], 2).values
        out.append(int(torch.argmax(logits[0])))
        gaps.append(float(top2[0] - top2[1]))
    return out, gaps


def _family_engines(arch, script, *, bf16, **kw):
    jcfg, cfg, jp, p = _family(arch)
    out = []
    for engine in ((JServeEngine(jcfg, jp, **kw),
                    ServeEngine(cfg, p, device="cpu", **kw)) if bf16 else
                   (JServeEngine(jcfg, jp, dtype=jnp.float32, **kw),
                    ServeEngine(cfg, p, dtype=torch.float32, device="cpu",
                                **kw))):
        uids = [engine.submit(prompt, **skw) for prompt, skw in script]
        out.append((engine, uids, engine.run_until_drained()))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_engine_matches_reference(arch):
    """f32 caches: both engines finish the same requests in the same order
    with the same tokens, each the port's single-request loop's."""
    _, cfg, _, p = _family(arch)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (12, 5, 16, 9)]     # 4 requests through 2 slots
    (jengine, juids, jdone), (engine, uids, done) = _family_engines(
        arch, [(q, {"max_new_tokens": 6}) for q in prompts], bf16=False,
        slots=2, max_ctx=48, prompt_buckets=(16,))
    assert uids == juids and len(done) == 4
    assert [(r.uid, r.tokens) for r in done] == \
        [(r.uid, r.tokens) for r in jdone]
    assert {k: engine.stats()[k] for k in COUNT_KEYS} == \
        {k: jengine.stats()[k] for k in COUNT_KEYS}
    by_uid = {r.uid: r.tokens for r in done}
    for uid, q in zip(uids, prompts):
        want, _ = _port_loop(cfg, p, q, 16, 6, 48, torch.float32)
        assert by_uid[uid] == want, uid


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_engine_matches_reference_on_bf16_caches(arch):
    """The engines' default bf16 caches under f32 weights (the SSD state
    stays f32).  The reference's ``conv`` leaf turns f32 on its first tick
    (``docs/torch_lm.md``, divergence 7), so the engines are held token for
    token up to the first step whose two largest logits, in the port's
    single-request loop on bf16 caches, lie within ``TIE`` = 0.02: past
    one, a bf16 rounding of the conv window may rightly pick the other."""
    _, cfg, _, p = _family(arch)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (12, 5, 16, 9)]
    (jengine, juids, jdone), (engine, uids, done) = _family_engines(
        arch, [(q, {"max_new_tokens": 6}) for q in prompts], bf16=True,
        slots=2, max_ctx=48, prompt_buckets=(16,))
    leaf = "conv" if cfg.ssm_layers else "k"
    assert engine.caches["p0"][leaf].dtype == torch.bfloat16
    if cfg.ssm_layers:
        assert engine.caches["p0"]["state"].dtype == torch.float32
    assert uids == juids and len(done) == len(jdone) == 4
    TIE = 0.02
    mine = {r.uid: r.tokens for r in done}
    ref = {r.uid: r.tokens for r in jdone}
    compared = 0
    for uid, q in zip(uids, prompts):
        want, gaps = _port_loop(cfg, p, q, 16, 6, 48, torch.bfloat16)
        n = next((i + 1 for i, g in enumerate(gaps) if g < TIE), len(want))
        assert mine[uid][:n] == ref[uid][:n] == want[:n], uid
        compared += n
    assert compared >= 12, compared


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_reused_slot_leaks_no_ssd_state(arch):
    """One slot, two requests: the second runs in the slot the first left,
    its conv window and state overwritten at admission, and generates what
    it generates in a fresh engine and in the reference's engine."""
    _, cfg, _, p = _family(arch)
    rng = np.random.default_rng(10)
    first, second = (rng.integers(0, cfg.vocab_size, n) for n in (14, 7))
    kw = dict(slots=1, max_ctx=48, prompt_buckets=(16,))
    (_, _, jdone), (engine, uids, done) = _family_engines(
        arch, [(first, {"max_new_tokens": 5}),
               (second, {"max_new_tokens": 5})], bf16=False, **kw)
    assert [r.tokens for r in done] == [r.tokens for r in jdone]
    fresh = ServeEngine(cfg, p, dtype=torch.float32, device="cpu", **kw)
    fresh.submit(second, max_new_tokens=5)
    (alone,) = fresh.run_until_drained()
    assert done[1].uid == uids[1] and done[1].tokens == alone.tokens
    state = engine.caches["p0"]["state"]
    assert bool(state.any())                  # the second request's state


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_serves_each_family_on_the_cpu(arch, capsys):
    """``launch.serve --arch <arch> --device cpu`` at ``reduced()``."""
    stats = serve_cli.main(["--arch", arch, "--device", "cpu"])
    assert stats["requests"] == 12
    assert stats["tier0_interactive"] + stats["tier1_batch"] == 12
    assert '"requests": 12' in capsys.readouterr().out
