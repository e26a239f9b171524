"""Optimizers, from scratch (torch).

Mirrors ``repro/train/optimizer.py``: three choices behind one
``(grads, state, params, step) -> (new_params, new_state)`` interface.

  adamw      f32 master copy + two f32 moments (12 bytes a parameter of
             state beside the parameters in their own dtype)
  adafactor  factored second moment (row + column statistics of every
             leaf of two or more dims), no first moment, parameters
             updated in their stored dtype
  sgd        no state

State trees mirror the parameter tree.  Gradient clipping is by global
norm, in f32, each leaf cast back to its dtype; the norm travels in the
new state as ``gnorm``, which the train step pops.  Every update is
functional: it returns new tensors and writes none it is given.

Copied quirks of the reference (``docs/torch_lm_train.md``):
  * ``_decayable`` reads only the leaf's last key, so a bias named
    ``bq`` / ``bk`` / ``bv`` (qwen2) and zamba2's LoRA ``a`` / ``b`` decay;
  * Adafactor factors by ``ndim >= 2``, which counts a stacked ``[nB]``
    axis: a stacked norm scale ``[nB, D]`` keeps ``vr [nB]`` and ``vc
    [D]``; its update-clipping RMS is over the whole leaf;
  * the bias corrections ``beta ** t`` and the schedule are f32 scalars
    on the parameters' device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.train.tree import tree_leaves, tree_map, tree_map_with_path

Params = Any

__all__ = ["OptimizerConfig", "Optimizer", "make_optimizer",
           "global_norm", "clip_by_global_norm", "lr_schedule"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | adafactor | sgd
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8          # beta2_t = 1 - t^-decay_rate
    epsilon1: float = 1e-30
    # schedule
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptimizerConfig
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / norm.clamp_min(1e-12), 1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32."""
    step = step.float()
    warm = torch.clamp_max((step + 1.0) / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _decayable(path: tuple) -> bool:
    """Weight decay only on matrices (not norms / biases / scalars), judged
    by the leaf's last key alone, as the reference does."""
    name = str(path[-1]) if path else ""
    return name not in ("scale", "bias", "A_log", "D", "dt_bias")


def _unzip(flat, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    return [tree_map(lambda t, i=i: t[i], flat) for i in range(n)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {
            "mu": tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                           params),
            "master": tree_map(lambda x: x.float().clone(), params),
        }

    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_schedule(cfg, step)
        t = step.float() + 1.0
        c1 = 1.0 - cfg.beta1 ** t
        c2 = 1.0 - cfg.beta2 ** t

        def one(path, g, mu, nu, master):
            g = g.float()
            mu = cfg.beta1 * mu + (1 - cfg.beta1) * g
            nu = cfg.beta2 * nu + (1 - cfg.beta2) * g * g
            upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            if _decayable(path):
                upd = upd + cfg.weight_decay * master
            master = master - lr * upd
            return mu, nu, master

        mu, nu, master = _unzip(tree_map_with_path(
            one, grads, state["mu"], state["nu"], state["master"]), 3)
        new_params = tree_map(lambda m, p: m.to(p.dtype), master, params)
        return new_params, {"mu": mu, "nu": nu, "master": master,
                            "gnorm": gnorm}

    return Optimizer(cfg, init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; state ~= params/row + params/col)
# ---------------------------------------------------------------------------


def _adafactor(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def one(x):
            f32 = dict(dtype=torch.float32, device=x.device)
            if x.ndim >= 2:
                # factor over the last two dims; store row / col means
                return {"vr": torch.zeros(x.shape[:-1], **f32),
                        "vc": torch.zeros(x.shape[:-2] + x.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(x.shape, **f32)}
        return {"v": tree_map(one, params)}

    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_schedule(cfg, step)
        t = step.float() + 1.0
        beta2t = 1.0 - torch.pow(t, -cfg.decay_rate)

        def one(path, g, p, v):
            g = g.float()
            g2 = g * g + cfg.epsilon1
            if g.ndim >= 2:
                vr = beta2t * v["vr"] + (1 - beta2t) * g2.mean(dim=-1)
                vc = beta2t * v["vc"] + (1 - beta2t) * g2.mean(dim=-2)
                vr_mean = vr.mean(dim=-1, keepdim=True)
                precond = (vr[..., None]
                           / vr_mean[..., None].clamp_min(cfg.epsilon1)
                           ) * vc[..., None, :]
                upd = g / torch.sqrt(precond.clamp_min(cfg.epsilon1))
                new_v = {"vr": vr, "vc": vc}
            else:
                vv = beta2t * v["v"] + (1 - beta2t) * g2
                upd = g / torch.sqrt(vv.clamp_min(cfg.epsilon1))
                new_v = {"v": vv}
            # update clipping (Shazeer & Stern RMS rule), over the whole leaf
            rms = torch.sqrt(upd.square().mean() + 1e-30)
            upd = upd / rms.clamp_min(1.0)
            pf = p.float()
            if _decayable(path):
                upd = upd + cfg.weight_decay * pf
            return (pf - lr * upd).to(p.dtype), new_v

        # the params drive the structure; each leaf's state is a dict
        flat = tree_map_with_path(
            lambda path, g, p: one(path, g, p, _at(state["v"], path)),
            grads, params)
        new_params, new_v = _unzip(flat, 2)
        return new_params, {"v": new_v, "gnorm": gnorm}

    return Optimizer(cfg, init, update)


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_schedule(cfg, step)
        new_params = tree_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
            params, grads)
        return new_params, {"gnorm": gnorm}

    return Optimizer(cfg, init, update)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return _adamw(cfg)
    if cfg.name == "adafactor":
        return _adafactor(cfg)
    if cfg.name == "sgd":
        return _sgd(cfg)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
