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
from repro_torch.dist.compression import compress_grads_crosspod
from repro_torch.dist.sharding import (ShardingPlan, make_plan, param_specs,
                                       tree_named)
from repro_torch.models.lm import params_from_arrays
from repro_torch.models.registry import get_bundle
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainState", "init_state", "state_shapes", "state_from_arrays",
           "make_train_step", "jit_train_step", "deterministic_algorithms"]

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
    it is a no-op, as in the reference."""
    del vocab_chunk
    splan = splan or make_plan(cfg, None)
    compress = (grad_compress and splan.mesh is not None
                and "pod" in splan.mesh.axis_names)
    bundle = get_bundle(cfg)

    def loss_and_grads(params, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        loss = bundle.loss(cfg, tree_unflatten(params, leaves), batch, splan)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, grads)

    def step_fn(state, batch):
        params = state["params"]
        device = state["step"].device
        with deterministic_algorithms(deterministic and
                                      device.type == "cuda"):
            batch = _to_device(batch, device)
            if microbatches <= 1:
                loss, grads = loss_and_grads(params, batch)
            else:
                acc = tree_map(lambda x: torch.zeros_like(
                    x, dtype=torch.float32), params)
                losses = []
                for i in range(microbatches):
                    mb = {k: x.reshape((microbatches,
                                        x.shape[0] // microbatches)
                                       + x.shape[1:])[i]
                          for k, x in batch.items()}
                    l, g = loss_and_grads(params, mb)
                    acc = tree_map(lambda a, b: a + b.float(), acc, g)
                    losses.append(l)
                grads = tree_map(lambda g: g / microbatches, acc)
                loss = torch.stack(losses).mean()
            if compress:
                grads = compress_grads_crosspod(grads, splan.mesh)
            new_params, new_opt = opt.update(grads, state["opt"], params,
                                             state["step"])
        metrics = {"loss": loss, "gnorm": new_opt.pop("gnorm")}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return step_fn


def _place(state: dict, mesh) -> dict:
    """The state laid out as the reference's shardings lay it out: params
    and optimizer state by ``param_specs``, the step replicated."""
    def put(specs, tree):
        return tree_map(lambda sh, t: sh.place(t),
                        tree_named(mesh, specs), tree)
    return {"params": put(param_specs(state["params"], mesh),
                          state["params"]),
            "opt": put(param_specs(state["opt"], mesh), state["opt"]),
            "step": tree_named(mesh, param_specs(state["step"], mesh))
            .place(state["step"])}


def jit_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None, **kw):
    """``(step_fn, splan)``, with no ``jit`` (eager PyTorch compiles
    nothing).  With a mesh the step places its input and output state by
    ``param_specs`` / ``tree_named``, as the reference's in / out
    shardings do, and donates nothing: the state it is given stays as it
    was."""
    splan = make_plan(cfg, mesh)
    step_fn = make_train_step(cfg, opt, splan, **kw)
    if mesh is None:
        return step_fn, splan

    def placed(state, batch):
        new, metrics = step_fn(_place(state, mesh), batch)
        return _place(new, mesh), metrics

    return placed, splan
