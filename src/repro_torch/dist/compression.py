"""Gradient compression for the cross-pod all-reduce (torch).

Mirrors ``repro/dist/compression.py``: int8 symmetric quantization moves
4x fewer bytes over slow inter-pod links; error feedback keeps the
accumulated update unbiased (the quantization residual of step k is added
back into the gradient of step k+1, so the compressed stream's running
mean converges to the true gradient mean).  Rounding is half to even, as
``jnp.round`` rounds, so the codes equal the reference's bit for bit.  The
trainer calls ``compress_grads_crosspod`` only under a mesh with a ``pod``
axis (``train/trainer.py``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.collectives import record_collective, recording
from repro_torch.dist.sharding import NamedSharding, param_specs
from repro_torch.train.tree import tree_leaves, tree_map

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "init_error_feedback",
    "compress_with_error_feedback",
    "compress_grads_crosspod",
]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric round-to-nearest-even int8: returns (q int8, scale f32
    scalar); max |x - dequantize(q, s)| <= s / 2 by construction."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _roundtrip(x: torch.Tensor) -> torch.Tensor:
    q, s = quantize_int8(x)
    return dequantize_int8(q, s).to(x.dtype)


def init_error_feedback(grads):
    """Zero residual accumulator, matching the grad tree (f32)."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def compress_with_error_feedback(grads, ef):
    """(grads, residuals) -> (quantize-dequantized grads, new residuals).

    The transmitted value is Q(g + e); the residual e' = (g + e) - Q(g + e)
    is carried to the next step, so sum_k Q(g + e_k) -> sum_k g.
    """
    def one(g, e):
        c = g.float() + e
        sent = _roundtrip(c)
        return sent.to(g.dtype), c - sent

    flat = tree_map(one, grads, ef)
    return (tree_map(lambda t: t[0], flat), tree_map(lambda t: t[1], flat))


def _record_crosspod(grads, mesh) -> None:
    """The cross-pod all-reduce, as ``dist/collectives`` records it: over
    ``pod``, each position's shard (``param_specs``'s layout) of every
    floating leaf's int8 levels, and its f32 scale."""
    specs = tree_leaves(tree_map(lambda s: (s,), param_specs(grads, mesh)))
    for g, (spec,) in zip(tree_leaves(grads), specs):
        if not g.is_floating_point():
            continue
        shard = math.prod(NamedSharding(mesh, spec).shard_shape(g.shape))
        record_collective("all-reduce", shard + 4,
                          group=int(mesh.shape["pod"]), members=mesh.size)


def compress_grads_crosspod(grads, mesh):
    """Stateless int8 round trip of every floating leaf, applied before the
    cross-pod all-reduce (recorded here, on a mesh with a ``pod`` axis,
    while a recorder is set: ``launch/hlo_cost.analyze`` sets one)."""
    if (mesh is not None and "pod" in getattr(mesh, "axis_names", ())
            and recording()):
        _record_crosspod(grads, mesh)
    return tree_map(lambda g: _roundtrip(g) if g.is_floating_point() else g,
                    grads)
