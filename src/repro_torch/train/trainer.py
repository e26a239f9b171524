"""Train step assembly: loss -> grad -> (accumulate) -> clip -> update
(torch).

Mirrors ``repro/train/trainer.py`` without a mesh.  ``make_train_step``
returns a function ``(state, batch) -> (state, metrics)`` with the
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

Entry points run on ``cuda`` unless ``device="cpu"`` is passed.  Under a
mesh (``jit_train_step(mesh=...)``, cross-pod gradient compression) they
raise ``NotImplementedError`` naming ROADMAP queue 1 item 13e; the
dry-run's ``state_shapes`` waits for item 13f.
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
from repro_torch.dist.sharding import ShardingPlan, make_plan
from repro_torch.models.lm import params_from_arrays
from repro_torch.models.registry import get_bundle
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainState", "init_state", "state_from_arrays",
           "make_train_step", "jit_train_step", "deterministic_algorithms"]

Params = Any

_MESH_ITEM = ("training on a mesh ({what}) is ROADMAP queue 1 item 13e, "
              "not ported yet")


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
    ``grad_compress`` acts only under a mesh with a ``pod`` axis, which is
    item 13e: without one it is a no-op, as in the reference."""
    del vocab_chunk
    splan = splan or make_plan(cfg, None)
    if splan.mesh is not None:
        raise NotImplementedError(_MESH_ITEM.format(
            what="make_train_step, compress_grads_crosspod"))
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
            new_params, new_opt = opt.update(grads, state["opt"], params,
                                             state["step"])
        metrics = {"loss": loss, "gnorm": new_opt.pop("gnorm")}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return step_fn


def jit_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None, **kw):
    """``(step_fn, splan)``: the mesh-less step, with no ``jit`` (eager
    PyTorch compiles nothing).  A mesh raises ``NotImplementedError``
    naming item 13e."""
    if mesh is not None:
        raise NotImplementedError(_MESH_ITEM.format(what="jit_train_step"))
    splan = make_plan(cfg, None)
    return make_train_step(cfg, opt, splan, **kw), splan
