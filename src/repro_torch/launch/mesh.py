"""Local device meshes (torch; mirrors ``make_local_mesh`` of
``repro/launch/mesh.py``).

``make_production_mesh`` and the reference's TPU constants table belong
to the LM half and are not ported (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import Mesh

__all__ = ["make_local_mesh"]


def make_local_mesh(data: int = 1, model: int = 1, *, devices=None) -> Mesh:
    """A ``(data, model)`` mesh.

    With no ``devices``, the positions are distinct cards ``cuda:0`` ..
    ``cuda:{data * model - 1}``, and too few cards raise: a requested mesh
    is never folded onto fewer cards.  ``devices`` lists one device a
    position, row-major over (data, model); repeats are allowed there and
    only there (eight ``"cpu"`` positions for tests, eight ``cuda:0``
    positions on a one-card machine).  Mixed device types raise."""
    n = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a ({data}, {model}) mesh of distinct cards needs {n} CUDA "
                f"devices, {have} available; pass devices= to place "
                f"positions on repeated devices explicitly")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a ({data}, {model}) mesh takes {n} devices, "
                         f"got {len(devices)}")
    grid = [devices[i * model:(i + 1) * model] for i in range(data)]
    return Mesh(grid, ("data", "model"))
