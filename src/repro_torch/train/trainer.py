"""Train step assembly: loss -> grad -> (accumulate) -> clip -> update
(torch).

Mirrors ``repro/train/trainer.py``.  ``make_train_step`` returns a function ``(state, batch) -> (state, metrics)`` with the
reference's functional contract: it writes nothing into the state it is
given, and the new state is new tensors.  Gradients come from
``torch.autograd.grad`` over detached aliases of the parameters that
require grad; with ``microbatches > 1`` a Python loop accumulates f32
gradients and divides them, as the reference's ``lax.scan`` does.  The
batch is the pipeline's numpy arrays (``train/data.py``); token ids become
int64 tensors on the parameters' device only as they enter the model.

On the card each step runs under ``torch.use_deterministic_algorithms``
(``deterministic=True``, the default), which keeps the reference's
promise of a bit-identical continuation after a restore: the embedding's
backward and the MoE's scatters then sum in a fixed order.  Ops that have
no deterministic CUDA kernel (the SSD families' float ``cumsum``) warn
instead of raising (``docs/torch_lm_train.md``).

On a mesh (a plan from ``make_plan(cfg, mesh)``) the loss runs under the
plan (the MoE's per-block dispatch, ``models/layers.py``), and with
``grad_compress`` and a ``pod`` axis every floating gradient makes the
int8 round trip of ``dist/compression.compress_grads_crosspod`` between
accumulation and the update, as the reference's step does before its
cross-pod all-reduce.  ``jit_train_step(cfg, opt, mesh)`` places the state
by ``param_specs`` / ``tree_named`` on the mesh's one device, in and out;
it compiles nothing and donates nothing: eager PyTorch has no donation,
and the step keeps its functional contract (``docs/torch_lm_mesh.md``).

Over positions that own their shards (the default over distinct devices,
or ``own_shards=True``) the state is ``Sharded`` pieces: the parameters
and the optimizer state by ``param_specs``, the step a copy a position.
The step takes ``requires_grad`` aliases of every piece and runs the loss
through ``models/positions.py``; autograd runs back through every move
(``dist/collectives``), so a leaf's gradient pieces come back reduced over
``data`` where the leaf is FSDP-split (the all-gather's transpose), and
the copies of a replicated piece are summed over the axes that do not
split it, ``pod`` last (the cross-pod all-reduce, recorded at int8 bytes
under ``grad_compress``).  Microbatches accumulate piece by piece; the
int8 round trip takes each leaf's scale over its distinct slices; the
optimizer updates each piece.  The loss and ``gnorm`` come back to the
controller (the first position's device).

Entry points run on ``cuda`` unless ``device="cpu"`` is passed.  The
dry-run's ``state_shapes`` is ``init_state`` on ``meta``: every leaf's
shape and dtype, nothing allocated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as C
from repro_torch.dist.compression import compress_grads_crosspod
from repro_torch.dist.sharding import (P, Sharded, ShardingPlan, make_plan,
                                       param_specs, place_tree, tree_named)
from repro_torch.models.lm import params_from_arrays
from repro_torch.models.registry import get_bundle
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainState", "init_state", "state_shapes", "state_from_arrays",
           "loss_and_grads", "make_train_step", "jit_train_step",
           "place_state", "deterministic_algorithms"]

Params = Any

@dataclasses.dataclass
class TrainState:
    params: Params
    opt: Any
    step: torch.Tensor

    def tree(self):
        return {"params": self.params, "opt": self.opt, "step": self.step}


def init_state(cfg: ModelConfig, opt: Optimizer, gen: torch.Generator, *,
               dtype=torch.bfloat16, device=None) -> dict:
    """Parameters drawn from ``gen`` (a generator on ``device``), their
    optimizer state and step 0 (int32)."""
    device = resolve_device(device)
    params = get_bundle(cfg).init(cfg, gen, dtype=dtype, device=device)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_shapes(cfg: ModelConfig, opt: Optimizer, *,
                 dtype=torch.bfloat16) -> dict:
    """The abstract state for the dry-run: ``init_state`` on ``meta``,
    which allocates nothing.  The draws take a CPU generator (a ``meta``
    one cannot be made) that draws nothing on ``meta``."""
    return init_state(cfg, opt, torch.Generator(), dtype=dtype,
                      device="meta")


def state_from_arrays(tree, *, device=None) -> dict:
    """A reference train state (``{"params", "opt", "step"}`` as nested
    dicts of numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray,
    state)``) as tensors on ``device``, leaf for leaf and dtype for dtype
    (bfloat16 included): the port's and the reference's steps then start
    from the same state."""
    return params_from_arrays(tree, device=device)


@contextlib.contextmanager
def deterministic_algorithms(enabled: bool = True):
    """Run the enclosed ops under ``torch.use_deterministic_algorithms``
    (``warn_only``: an op with no deterministic kernel warns), restoring
    the previous mode after.  cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG``
    set; ``:4096:8`` is set when absent, which on sm_90 is the size
    PyTorch picks by default, so no workspace changes."""
    if not enabled:
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    # nothing on the path reads memory it has not written
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _to_device(batch: dict, device: torch.device) -> dict:
    """The pipeline's arrays as tensors: integer ids int64, the rest as
    they are (frames f32)."""
    out = {}
    for k, a in batch.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def _whole_grads(grads, splan: ShardingPlan, *, compress: bool):
    """Own-shards gradient pieces summed over the copies of each leaf:
    over the axes that split nothing of it, ``pod`` last (the cross-pod
    all-reduce; under ``compress`` recorded at the int8 bytes it carries,
    each piece's levels and an f32 scale)."""
    names = tuple(splan.mesh.axis_names)

    def one(g: Sharded) -> Sharded:
        split = {a for d in range(g.ndim) for a in g.entry(d)}
        g = C.psum(g, tuple(a for a in names
                            if a not in split and a != "pod"))
        if "pod" in names and "pod" not in split:
            g = C.psum(g, ("pod",), wire_bytes=g.first.numel() + 4
                       if compress and g.dtype.is_floating_point else None)
        return g

    return tree_map(one, grads)


def loss_and_grads(cfg: ModelConfig, params, batch: dict,
                   splan: ShardingPlan | None = None):
    """The loss and its gradients over ``params`` (``batch`` tensors on
    the controller), as the train step takes them.  Over own shards the
    gradients are ``Sharded`` by the parameters' specs, each piece the
    position's share: reduced over ``data`` where the leaf is split
    there, partial over the axes that split nothing of it (the step sums
    those: ``_whole_grads``)."""
    splan = splan or make_plan(cfg, None)
    loss_fn = get_bundle(cfg).loss
    if not splan.own_shards:
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch, splan)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, grads)
    aliases = [x.map(lambda pos, t: t.detach().requires_grad_(True))
               for x in tree_leaves(params)]
    loss = loss_fn(cfg, tree_unflatten(params, aliases), batch, splan)
    flat = [t for x in aliases for t in x.pieces.values()]
    got = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grads = []
    for x in aliases:
        pieces = {}
        for pos, t in x.pieces.items():
            g = next(got)
            pieces[pos] = torch.zeros_like(t) if g is None else g
        grads.append(Sharded(x.mesh, x.spec, pieces))
    return loss.detach(), tree_unflatten(params, grads)


def _each(x, fn, *rest):
    """``fn`` of a tensor (and ``rest``'s), or of each position's pieces of
    a ``Sharded``: the accumulation of microbatches piece by piece."""
    if isinstance(x, Sharded):
        return x.map(lambda pos, t: fn(t, *(r.pieces[pos] for r in rest)))
    return fn(x, *rest)


def _controller(state: dict) -> torch.device:
    step = state["step"]
    return (step.first if isinstance(step, Sharded) else step).device


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    splan: ShardingPlan | None = None, *,
                    microbatches: int = 1, grad_compress: bool = False,
                    vocab_chunk: int = 16_384,
                    deterministic: bool = True) -> Callable:
    """(state, batch) -> (state, metrics {loss, gnorm}); the state is left
    as it was given.  ``vocab_chunk`` is accepted and unused, as in the
    reference: the loss keeps its default chunk of 16,384.
    ``grad_compress`` acts only under a mesh with a ``pod`` axis (the int8
    round trip of every floating gradient before the update); without one
    it is a no-op, as in the reference.  Under a plan whose positions own
    their shards the state is pieces (``place_state``) and stays so."""
    del vocab_chunk
    splan = splan or make_plan(cfg, None)
    own = splan.own_shards
    compress = (grad_compress and splan.mesh is not None
                and "pod" in splan.mesh.axis_names)

    def step_fn(state, batch):
        params = state["params"]
        device = _controller(state)
        with deterministic_algorithms(deterministic and
                                      device.type == "cuda"):
            batch = _to_device(batch, device)
            if microbatches <= 1:
                loss, grads = loss_and_grads(cfg, params, batch, splan)
            else:
                acc = tree_map(lambda x: _each(x, lambda t: torch.zeros_like(
                    t, dtype=torch.float32)), params)
                losses = []
                for i in range(microbatches):
                    mb = {k: x.reshape((microbatches,
                                        x.shape[0] // microbatches)
                                       + x.shape[1:])[i]
                          for k, x in batch.items()}
                    l, g = loss_and_grads(cfg, params, mb, splan)
                    acc = tree_map(lambda a, b: _each(
                        a, lambda t, u: t + u.float(), b), acc, g)
                    losses.append(l)
                grads = tree_map(lambda g: _each(g, lambda t: t / microbatches),
                                 acc)
                loss = torch.stack(losses).mean()
            if own:
                grads = _whole_grads(grads, splan, compress=compress)
            if compress:
                grads = compress_grads_crosspod(grads, splan.mesh)
            new_params, new_opt = opt.update(grads, state["opt"], params,
                                             state["step"])
        gnorm = new_opt.pop("gnorm")
        if own:
            gnorm = C.gather_to(gnorm, device)
            nxt = state["step"].map(lambda pos, t: t + 1)
        else:
            nxt = state["step"] + 1
        return ({"params": new_params, "opt": new_opt, "step": nxt},
                {"loss": loss, "gnorm": gnorm})

    return step_fn


def place_state(state: dict, mesh, *, own_shards: bool = False) -> dict:
    """The state laid out as the reference's shardings lay it out: params
    and optimizer state by ``param_specs``, the step replicated.  Held
    once: each leaf on the mesh's one device (``NamedSharding.place``);
    ``own_shards``: each leaf as pieces (``place_tree``; a ``Sharded``
    leaf stays as it is)."""
    def put(tree):
        specs = param_specs(tree, mesh)
        if own_shards:
            return place_tree(tree, specs, mesh)
        return tree_map(lambda sh, t: sh.place(t), tree_named(mesh, specs),
                        tree)
    return {"params": put(state["params"]), "opt": put(state["opt"]),
            "step": put(state["step"])}


def jit_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None, *,
                   own_shards: bool | None = None, **kw):
    """``(step_fn, splan)``, with no ``jit`` (eager PyTorch compiles
    nothing).  With a mesh the step places its input and output state by
    ``param_specs`` (``place_state``), as the reference's in / out
    shardings do, and donates nothing: the state it is given stays as it
    was.  ``own_shards`` is ``make_plan``'s: by default pieces over
    distinct devices, held once on one device; True asks for pieces on
    repeated positions."""
    splan = make_plan(cfg, mesh, own_shards=own_shards)
    step_fn = make_train_step(cfg, opt, splan, **kw)
    if mesh is None:
        return step_fn, splan
    own = splan.own_shards

    def placed(state, batch):
        new, metrics = step_fn(place_state(state, mesh, own_shards=own),
                               batch)
        return place_state(new, mesh, own_shards=own), metrics

    return placed, splan
