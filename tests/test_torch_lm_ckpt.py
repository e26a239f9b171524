"""Port parity: checkpoints (``repro_torch.train.checkpoint``) and the
fault-tolerant loop (``repro_torch.train.fault``) on the CPU.

  * an f32 train state written by either package restores in the other
    bit for bit (the same ``step_%08d/`` layout, ``manifest.json`` and
    ``.npy`` files);
  * bf16 leaves: saved as their 16 bits (2-byte void items, the bits the
    reference's ``np.save`` writes) with dtype ``"bfloat16"``, restored
    bit for bit, a reference-written bf16 leaf included (the reference
    cannot restore its own: pinned below);
  * the atomic ``.tmp`` rename, ``latest_step`` skipping a ``.tmp``, a
    shape mismatch raising ``ValueError``, a missing leaf ``KeyError``,
    a restore onto the ``like`` leaf's dtype, a restore onto a one-device
    mesh and one over two distinct (CPU-index) devices as pieces;
  * the reference's ``tests/test_checkpoint.py`` claims on the port: a
    round trip, train 10 straight == train 5, restore, train 5, and a
    failure injected at step 7 recovered from step 5 to the same state,
    bit for bit; the straggler flag, here on a scripted clock, equal to
    the reference loop's on the same clock.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as JK
from repro.train import fault as JF
from repro_torch import configs
from repro_torch.dist.sharding import Mesh
from repro_torch.train import checkpoint as K
from repro_torch.train import fault as F
from repro_torch.train.data import DataConfig, synthetic_batch
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import (init_state, make_train_step,
                                       state_from_arrays)

CFG = configs.reduced(configs.get_config("olmo-1b"))
OPT = make_optimizer(OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=2))
DC = DataConfig(seed=5, vocab_size=CFG.vocab_size, batch=4, seq_len=32)


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy(
    ).tobytes()


def _same(a, b) -> bool:
    """Bit for bit: the same paths, dtypes, shapes and bytes."""
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and x.shape == y.shape and _bits(x) == _bits(y)
        for (_, x), (_, y) in zip(fa, fb))


def _state(seed: int = 0):
    return init_state(CFG, OPT, torch.Generator().manual_seed(seed),
                      dtype=torch.float32, device="cpu")


def _loop(ckpt_dir=None, **kw):
    return F.TrainLoop(make_train_step(CFG, OPT),
                       lambda k: synthetic_batch(DC, k), ckpt_dir=ckpt_dir,
                       ckpt_every=5, **kw)


@functools.lru_cache(maxsize=None)
def _straight(steps: int):
    """An uninterrupted run of ``steps`` steps from ``_state()``."""
    state, report = _loop().run(_state(), steps)
    return state, report


def _arrays(state) -> dict:
    return jax.tree_util.tree_map(lambda t: t.numpy(), state)


# -- the format across packages -------------------------------------------------


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    state = _straight(2)[0]
    jstate = jax.tree_util.tree_map(jnp.asarray, _arrays(state))
    JK.save_checkpoint(str(tmp_path), jstate, 2)
    got, step = K.restore_checkpoint(str(tmp_path), _state(1))
    assert step == 2 and K.latest_step(str(tmp_path)) == 2
    assert _same(got, state)


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    state = _straight(2)[0]
    out = K.save_checkpoint(str(tmp_path), state, 2)
    assert out == os.path.join(str(tmp_path), "step_00000002")
    like = jax.tree_util.tree_map(jnp.asarray, _arrays(_state(1)))
    got, step = JK.restore_checkpoint(str(tmp_path), like)
    assert step == 2
    back = state_from_arrays(jax.tree_util.tree_map(np.asarray, got),
                             device="cpu")
    assert _same(back, state)
    # the same manifest as the reference writes for the same state
    jdir = tmp_path / "ref"
    JK.save_checkpoint(str(jdir), like, 2)
    mine = json.loads((tmp_path / "step_00000002" / "manifest.json")
                      .read_text())
    theirs = json.loads((jdir / "step_00000002" / "manifest.json")
                        .read_text())
    assert mine == theirs
    assert mine["leaves"]["opt/mu/blocks/p0/attn/wq"]["file"] == \
        "opt__mu__blocks__p0__attn__wq.npy"


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    r = np.random.default_rng(0)
    w = torch.from_numpy(r.normal(size=(3, 5)).astype(np.float32))
    state = {"params": {"w": w.to(torch.bfloat16),
                        "n": torch.tensor([-0.0, float("inf"),
                                           float("nan")]).to(torch.bfloat16)},
             "step": torch.tensor(4, dtype=torch.int32)}
    K.save_checkpoint(str(tmp_path / "a"), state, 4)
    meta = json.loads((tmp_path / "a" / "step_00000004" / "manifest.json")
                      .read_text())["leaves"]
    assert meta["params/w"] == {"file": "params__w.npy", "shape": [3, 5],
                                "dtype": "bfloat16"}
    got, _ = K.restore_checkpoint(str(tmp_path / "a"), state)
    assert _same(got, state)
    # the file holds the 16 bits the reference writes for the same leaf,
    # as 2-byte void items
    jw = jnp.asarray(w.numpy()).astype(jnp.bfloat16)
    JK.save_checkpoint(str(tmp_path / "b"), {"params": {"w": jw}}, 4)
    mine, theirs = (np.load(tmp_path / d / "step_00000004" / "params__w.npy")
                    for d in ("a", "b"))
    assert mine.dtype.kind == theirs.dtype.kind == "V"
    assert mine.dtype.itemsize == theirs.dtype.itemsize == 2
    assert mine.tobytes() == theirs.tobytes()
    # a reference-written bf16 leaf restores in the port bit for bit
    got, _ = K.restore_checkpoint(str(tmp_path / "b"),
                                  {"params": {"w": state["params"]["w"]}})
    assert _bits(got["params"]["w"]) == _bits(state["params"]["w"])


def test_reference_cannot_restore_its_own_bf16_leaves(tmp_path):
    """A reference defect the port does not share: ``np.save`` writes a
    bf16 leaf as ``|V2`` and the reference's restore casts it with
    ``astype(bfloat16)``, which numpy refuses."""
    leaf = {"w": jnp.ones((2, 2), jnp.bfloat16)}
    JK.save_checkpoint(str(tmp_path), leaf, 1)
    with pytest.raises(ValueError, match="No cast function"):
        JK.restore_checkpoint(str(tmp_path), leaf)
    got, _ = K.restore_checkpoint(
        str(tmp_path), {"w": torch.zeros((2, 2), dtype=torch.bfloat16)})
    assert torch.equal(got["w"], torch.ones((2, 2), dtype=torch.bfloat16))


def test_atomic_save_leaves_no_tmp(tmp_path):
    K.save_checkpoint(str(tmp_path), {"w": torch.zeros(3)}, 3)
    K.save_checkpoint(str(tmp_path), {"w": torch.ones(3)}, 3)  # overwrite
    entries = os.listdir(tmp_path)
    assert entries == ["step_00000003"]
    os.makedirs(tmp_path / "step_00000009.tmp")         # a crashed save
    assert K.latest_step(str(tmp_path)) == 3
    got, step = K.restore_checkpoint(str(tmp_path), {"w": torch.zeros(3)})
    assert step == 3 and got["w"].tolist() == [1.0, 1.0, 1.0]
    assert K.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        K.restore_checkpoint(str(tmp_path / "none"), {})


def test_restore_refusals_and_casts(tmp_path):
    K.save_checkpoint(str(tmp_path), {"w": torch.zeros((3, 3)),
                                      "x": torch.arange(4.0)}, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        K.restore_checkpoint(str(tmp_path), {"w": torch.zeros((2, 2))})
    with pytest.raises(KeyError, match="checkpoint missing leaf y"):
        K.restore_checkpoint(str(tmp_path), {"y": torch.zeros(1)})
    # onto a one-device mesh: each leaf placed by its spec; over distinct
    # devices (two CPU indices, which torch keeps apart) as pieces, each
    # its position's copy
    from repro_torch.dist.sharding import Sharded
    mesh = Mesh([["cpu"] * 2] * 2, ("data", "model"))
    got, _ = K.restore_checkpoint(str(tmp_path), {"w": torch.ones((3, 3))},
                                  mesh=mesh)
    assert torch.equal(got["w"], torch.zeros((3, 3)))
    two = Mesh([[torch.device("cpu", 0), torch.device("cpu", 1)]],
               ("data", "model"))
    got, _ = K.restore_checkpoint(str(tmp_path), {"x": torch.ones(4)},
                                  mesh=two)
    assert isinstance(got["x"], Sharded) and len(got["x"].pieces) == 2
    assert all(torch.equal(t, torch.arange(4.0))
               for t in got["x"].pieces.values())
    got, _ = K.restore_checkpoint(
        str(tmp_path), {"x": torch.zeros(4, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16 and got["x"].tolist() == \
        [0.0, 1.0, 2.0, 3.0]


# -- the loop -------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    loop = _loop(str(tmp_path))
    state, _ = loop.run(_state(), 6)
    restored, step = loop.restore(_state(1))
    assert step == 6
    assert _same(restored, state)


def test_bit_identical_continuation(tmp_path):
    """train 10 straight == train 5, 'crash', restore, train 5."""
    full = _straight(10)[0]
    loop = _loop(str(tmp_path))
    mid, _ = loop.run(_state(), 5)
    restored, step = loop.restore(_state(1))
    assert step == 5
    resumed, _ = loop.run(restored, 5, start_step=step)
    assert _same(resumed, full)
    assert int(resumed["step"]) == 10


def test_failure_injection_and_recovery(tmp_path):
    inj = F.FailureInjector(fail_at=7)
    loop = _loop(str(tmp_path), injector=inj)
    with pytest.raises(RuntimeError, match="injected node failure"):
        loop.run(_state(), 20)
    # the checkpoint at step 5 survives; the restart continues to 10
    assert K.latest_step(str(tmp_path)) == 5
    restored, step = loop.restore(_state(1))
    assert step == 5
    state, report = loop.run(restored, 5, start_step=step)
    assert int(state["step"]) == 10 and report.final_step == 10
    assert _same(state, _straight(10)[0])
    assert report.losses == _straight(10)[1].losses[5:]
    assert inj.fired


class _Clock:
    """A scripted ``time.perf_counter``: each step's pair of reads spans
    the next scripted duration."""

    def __init__(self, durations):
        self.t, self.pending, self.reads = 0.0, list(durations), 0

    def __call__(self):
        if self.reads % 2:
            self.t += self.pending.pop(0)
        self.reads += 1
        return self.t


@pytest.mark.parametrize("durations", [
    [2.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 1.0, 0.1, 0.1],
    [0.1, 0.1, 0.5, 0.1, 0.1, 0.1, 0.1, 0.1, 0.45, 0.1],
])
def test_straggler_flags_equal_the_references(durations, monkeypatch):
    """The EWMA rule (step 0 left out, flags only once three steps ran)
    on a scripted clock, in both loops: the same steps flagged, the same
    hook calls."""
    def step_fn(state, batch):
        return {"step": state["step"] + 1}, {"loss": torch.tensor(0.5)}

    flagged = {}
    for name, mod, loop_cls in (("port", F, F.TrainLoop),
                                ("ref", JF, JF.TrainLoop)):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(durations))
        calls = []
        loop = loop_cls(step_fn, lambda k: None, straggler_factor=3.0,
                        on_straggler=lambda s, dt: calls.append(s))
        _, report = loop.run({"step": torch.tensor(0)}, len(durations),
                             start_step=0)
        flagged[name] = (report.stragglers, calls,
                         [round(t, 9) for t in report.step_times])
    assert flagged["port"] == flagged["ref"]
    assert flagged["port"][0] == flagged["port"][1]
    assert flagged["port"][0] == ([7] if durations[0] == 2.0 else [8])
