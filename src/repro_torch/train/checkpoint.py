"""Checkpointing (torch), the reference's on-disk layout.

Mirrors ``repro/train/checkpoint.py``:
  * ``<dir>/step_%08d/`` holds one ``.npy`` a leaf, named by the leaf's
    path joined by ``/`` with ``/`` -> ``__`` in the file name, and a
    ``manifest.json`` of ``{"step", "leaves": {name: {file, shape,
    dtype}}}``;
  * atomic: a save writes ``<dir>.tmp`` and renames it, so a crash mid-save
    never corrupts the latest checkpoint;
  * with the deterministic pipeline (``train/data.py``) a restore at step k
    replays batch k exactly, so the continuation is bit for bit.

So an f32 checkpoint written by either package restores in the other.
numpy has no bfloat16: a bf16 leaf is saved as its 16 bits in an array of
2-byte void items with dtype ``"bfloat16"`` in the manifest, the bits the
reference's ``np.save`` writes for one, and restored bit for bit (a
reference-written one too, which the reference itself cannot restore).
``restore_checkpoint(mesh=)`` is the reference's reshard on restore: every
leaf is placed by its ``param_specs`` spec over the CURRENT mesh (which may
differ from the one that saved): held once on the mesh's one device, or,
where the positions own their shards (``make_plan``'s rule: by default
over distinct devices; ``own_shards=True`` on repeated positions), as
pieces, each copied from the host to its own position
(``dist/sharding.shard_tensor``).  A state held as pieces (``Sharded``
leaves) saves in the same layout: one whole ``.npy`` a leaf, filled on
the host from each distinct slice, read once from the position that
holds its first copy; no whole leaf is built on a device.  So a
checkpoint crosses both packages and every mesh.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.dist.sharding import (NamedSharding, Sharded, coord,
                                       distinct_devices, param_specs,
                                       shard_tensor)
from repro_torch.train.tree import tree_flatten_with_path

Params = Any

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_BF16 = "bfloat16"


def _flatten(tree) -> dict[str, Any]:
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in tree_flatten_with_path(tree)}


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host tensor as the array ``np.save`` writes, and its dtype's
    name (bf16 as its 16 bits in 2-byte void items)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), _BF16
    host = t.numpy()
    return host, str(host.dtype)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, Sharded):
        return _pieces_to_host(leaf)
    return _host(torch.as_tensor(leaf).detach().cpu())


def _pieces_to_host(x: Sharded) -> tuple[np.ndarray, str]:
    """The whole value of ``x`` in one host buffer: each distinct slice
    copied once, from the position at index 0 along every axis that
    splits nothing of ``x``."""
    mesh = x.mesh
    names = tuple(mesh.axis_names)
    split = [a for d in range(x.ndim) for a in x.entry(d)]
    buf = torch.empty(x.shape, dtype=x.dtype)
    for pos, t in x.pieces.items():
        if any(pos[names.index(a)] for a in names if a not in split):
            continue
        idx = tuple(slice(coord(mesh, pos, x.entry(d)) * n,
                          (coord(mesh, pos, x.entry(d)) + 1) * n)
                    for d, n in enumerate(t.shape))
        buf[idx] = t.detach().cpu()
    return _host(buf)


def save_checkpoint(ckpt_dir: str, state: Params, step: int) -> str:
    """Write ``state`` (any nested dict of tensors) as
    ``<dir>/step_<k>/``."""
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": int(step), "leaves": {}}
    for name, leaf in _flatten(state).items():
        host, dtype = _to_host(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), host)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(host.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.replace(tmp, out)
    return out


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == _BF16:                          # the 16 bits as void items
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(ckpt_dir: str, like: Params, *, mesh=None,
                       own_shards: bool | None = None,
                       step: int | None = None) -> tuple[Params, int]:
    """Restore into the structure of ``like`` (a state tree of tensors or
    ``Sharded`` leaves): each leaf in ``like``'s leaf's dtype, onto
    ``like``'s leaf's device, or with ``mesh`` placed by the leaf's
    ``param_specs`` spec over it: held once on its one device, or as
    pieces where its positions own their shards (``own_shards``;
    default: over distinct devices).  Returns (state, step).  A leaf of
    another shape raises ``ValueError``, a missing one ``KeyError``."""
    own = mesh is not None and (distinct_devices(mesh) if own_shards is None
                                else bool(own_shards))
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as fh:
        manifest = json.load(fh)

    flat_like = _flatten(like)
    flat_specs = _flatten(param_specs(like, mesh)) if mesh is not None \
        else {}
    leaves_by_name = {}
    for name, meta in manifest["leaves"].items():
        want = flat_like.get(name)
        if want is None:
            continue
        t = _load(os.path.join(src, meta["file"]), meta["dtype"])
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {tuple(t.shape)} vs "
                f"model {tuple(want.shape)}")
        if own:
            leaves_by_name[name] = shard_tensor(t.to(want.dtype), mesh,
                                                flat_specs[name])
        elif mesh is not None:
            leaves_by_name[name] = NamedSharding(
                mesh, flat_specs[name]).place(t.to(want.dtype))
        else:
            leaves_by_name[name] = t.to(device=want.device, dtype=want.dtype)

    def rebuild(node, prefix: tuple):
        if isinstance(node, dict):
            return {k: rebuild(v, prefix + (k,)) for k, v in node.items()}
        name = "/".join(str(k) for k in prefix)
        if name not in leaves_by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        return leaves_by_name[name]

    return rebuild(like, ()), int(step)
