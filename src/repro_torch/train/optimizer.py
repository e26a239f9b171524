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

Over positions that own their shards (``dist/sharding.Sharded`` leaves:
the parameters, the gradients as the train step reduces them, the state
and the step) each position updates its own piece with its own copy of
the step's scalars.  ``global_norm`` sums the squares of distinct slices
only (a replicated piece counts once, at the position that holds its
first copy), each position folding its leaves in tree order, and the
positions' sums are psummed (``dist/collectives``).  Adafactor's row and
column means and its whole-leaf RMS sum each position's partial over the
axes that split the reduced dimension.  The state is held by
``param_specs`` of the state tree (``_hold``), as the reference's
shardings hold it; a leaf whose state spec differs from its parameter's
(a stacked ``[nB, D]`` leaf: the state may split ``nB``; Adafactor's
``vr`` / ``vc``) is moved to the gradient's spec for the update and back.
No position holds a whole sharded leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import P, Sharded, param_specs
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


def _sharded(tree) -> bool:
    leaves = tree_leaves(tree)
    return bool(leaves) and isinstance(leaves[0], Sharded)


def _first_copy(x: Sharded, pos: tuple) -> bool:
    """Whether ``pos`` holds the first copy of its slice: index 0 along
    every axis that splits nothing of ``x``."""
    split = tuple(a for d in range(x.ndim) for a in x.entry(d))
    names = tuple(x.mesh.axis_names)
    return all(pos[names.index(a)] == 0 for a in names if a not in split)


def global_norm(tree):
    """The f32 norm of every leaf together; over ``Sharded`` leaves a
    ``Sharded`` scalar, the same at every position."""
    if _sharded(tree):
        leaves = tree_leaves(tree)
        mesh = leaves[0].mesh
        part = {}
        for pos in leaves[0].pieces:
            acc = None
            for x in leaves:
                t = x.pieces[pos].float()
                v = t.square().sum() if _first_copy(x, pos) else \
                    t.new_zeros(())
                acc = v if acc is None else acc + v
            part[pos] = acc
        return C.psum(Sharded(mesh, P(), part), mesh.axis_names).map(
            lambda pos, t: torch.sqrt(t))
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    if isinstance(norm, Sharded):
        scale = norm.map(lambda pos, n: torch.clamp_max(
            max_norm / n.clamp_min(1e-12), 1.0))
        return tree_map(lambda x: x.map(lambda pos, t: (
            t.float() * scale.pieces[pos]).to(t.dtype)), tree), norm
    scale = torch.clamp_max(max_norm / norm.clamp_min(1e-12), 1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def _scalars(fn, step):
    """``fn(step)``'s scalars, at every position of a ``Sharded`` step
    (``{pos: scalars}``), else once (``{None: scalars}``)."""
    if isinstance(step, Sharded):
        return {pos: fn(t) for pos, t in step.pieces.items()}
    return {None: fn(step)}


def _leafwise(fn, at: dict, spec_of, *leaves):
    """``fn(scalars, *pieces)`` (a tuple) at every position of a leaf's
    pieces, each ``Sharded`` input moved to ``spec_of``'s spec first, or
    once on plain tensors; returns the tuple of outputs (``Sharded`` under
    that spec)."""
    if not isinstance(leaves[0], Sharded):
        return fn(at[None], *leaves)
    spec = spec_of.spec
    moved = [C.relayout(x, spec) if isinstance(x, Sharded) else x
             for x in leaves]
    outs = {pos: fn(at[pos], *(x.pieces[pos] if isinstance(x, Sharded)
                               else x for x in moved))
            for pos in spec_of.pieces}
    n = len(next(iter(outs.values())))
    return tuple(Sharded(spec_of.mesh, spec, {pos: o[i]
                                              for pos, o in outs.items()})
                 for i in range(n))


def _hold(tree):
    """A tree of ``Sharded`` leaves moved to ``param_specs`` of the tree
    (the reference's shardings of a state); plain tensors as they are."""
    if not _sharded(tree):
        return tree
    mesh = tree_leaves(tree)[0].mesh
    return tree_map(lambda x, spec: C.relayout(x, spec), tree,
                    param_specs(tree, mesh))


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

        def scalars(st):
            t = st.float() + 1.0
            return (lr_schedule(cfg, st), 1.0 - cfg.beta1 ** t,
                    1.0 - cfg.beta2 ** t)

        at = _scalars(scalars, step)

        def one(path, g, mu, nu, master, p):
            def piece(sc, g, mu, nu, master, p):
                lr, c1, c2 = sc
                g = g.float()
                mu = cfg.beta1 * mu + (1 - cfg.beta1) * g
                nu = cfg.beta2 * nu + (1 - cfg.beta2) * g * g
                upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
                if _decayable(path):
                    upd = upd + cfg.weight_decay * master
                master = master - lr * upd
                return mu, nu, master, master.to(p.dtype)
            return _leafwise(piece, at, g, g, mu, nu, master, p)

        mu, nu, master, new_params = _unzip(tree_map_with_path(
            one, grads, state["mu"], state["nu"], state["master"], params), 4)
        new = _hold({"mu": mu, "nu": nu, "master": master})
        return new_params, {**new, "gnorm": gnorm}

    return Optimizer(cfg, init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; state ~= params/row + params/col)
# ---------------------------------------------------------------------------


def _mean(x: Sharded, dims: tuple, keepdim: bool = False) -> Sharded:
    """``x``'s mean over ``dims``: each position's sum over its slice,
    psummed over the axes that split those dimensions, over their whole
    length."""
    dims = tuple(d % x.ndim for d in dims)
    n = math.prod(x.shape[d] for d in dims)
    axes = tuple(a for d in dims for a in x.entry(d))
    entries = tuple(x.spec)
    if keepdim:
        spec = P(*(None if d in dims else e for d, e in enumerate(entries)))
    else:
        spec = P(*(e for d, e in enumerate(entries) if d not in dims))
    part = x.map(lambda pos, t: t.sum(dim=dims, keepdim=keepdim), spec=spec)
    return C.psum(part, axes).map(lambda pos, t: t / n)


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
        if _sharded(grads):
            return _adafactor_sharded(cfg, grads, gnorm, state, params, step)
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


def _adafactor_sharded(cfg: OptimizerConfig, grads, gnorm, state, params,
                       step):
    """Adafactor's update over ``Sharded`` leaves: each position's piece
    with its rows' ``vr`` and its columns' ``vc`` (the means psummed over
    the axes that split the reduced dimension), the RMS clip over the
    whole leaf likewise."""
    def scalars(st):
        t = st.float() + 1.0
        return lr_schedule(cfg, st), 1.0 - torch.pow(t, -cfg.decay_rate)

    at = _scalars(scalars, step)

    def decay(sc, a, b):
        return (sc[1] * a + (1 - sc[1]) * b,)

    def one(path, g, p, v):
        g2 = g.map(lambda pos, t: t.float() * t.float() + cfg.epsilon1)
        if g.ndim >= 2:
            row, col = _mean(g2, (-1,)), _mean(g2, (-2,))
            vr = _leafwise(decay, at, row, v["vr"], row)[0]
            vc = _leafwise(decay, at, col, v["vc"], col)[0]
            vrm = _mean(vr, (-1,), keepdim=True)

            def precond(pos, t):
                r, rm, c = vr.pieces[pos], vrm.pieces[pos], vc.pieces[pos]
                pre = (r[..., None] / rm[..., None].clamp_min(cfg.epsilon1)
                       ) * c[..., None, :]
                return t.float() / torch.sqrt(pre.clamp_min(cfg.epsilon1))

            upd = g.map(precond)
            new_v = {"vr": vr, "vc": vc}
        else:
            vv = _leafwise(decay, at, g2, v["v"], g2)[0]
            upd = g.map(lambda pos, t: t.float() / torch.sqrt(
                vv.pieces[pos].clamp_min(cfg.epsilon1)))
            new_v = {"v": vv}
        # update clipping (Shazeer & Stern RMS rule), over the whole leaf
        ms = _mean(upd.map(lambda pos, t: t.square()), tuple(range(g.ndim)))

        pp = C.relayout(p, g.spec)

        def piece(pos, u):
            u = u / torch.sqrt(ms.pieces[pos] + 1e-30).clamp_min(1.0)
            pf = pp.pieces[pos].float()
            if _decayable(path):
                u = u + cfg.weight_decay * pf
            return (pf - at[pos][0] * u).to(pp.dtype)

        return upd.map(piece), new_v

    flat = tree_map_with_path(
        lambda path, g, p: one(path, g, p, _at(state["v"], path)),
        grads, params)
    new_params, new_v = _unzip(flat, 2)
    return new_params, {**_hold({"v": new_v}), "gnorm": gnorm}


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        at = _scalars(lambda st: lr_schedule(cfg, st), step)
        new_params = tree_map(lambda p, g: _leafwise(
            lambda lr, p, g: ((p.float() - lr * g.float()).to(p.dtype),),
            at, g, p, g)[0], params, grads)
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
