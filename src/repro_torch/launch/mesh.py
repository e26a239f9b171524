"""Device meshes (torch; mirrors ``repro/launch/mesh.py``).

``make_local_mesh`` gives a ``(data, model)`` mesh, ``make_production_mesh``
the reference's production shapes, ``make_position_mesh`` any axes with
every position on one device.  ``H100`` is the dry-run's hardware table,
the counterpart of the reference's TPU table (whose numbers do not enter
the port): one NVIDIA H100 SXM, under the reference's key names.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import Mesh

__all__ = ["make_local_mesh", "make_position_mesh", "make_production_mesh",
           "H100"]

#: one NVIDIA H100 SXM, the roofline's peaks (``roofline_terms(peak=)``)
H100 = {
    # FLOP/s: dense bf16 tensor cores (NVIDIA H100 SXM data sheet, 989.4
    # TFLOP/s without sparsity)
    "peak_flops_bf16": 989.4e12,
    # B/s: HBM3 (NVIDIA H100 SXM data sheet, 3.35 TB/s)
    "hbm_bandwidth": 3.35e12,
    # B/s each way: NVLink 4 (NVIDIA H100 SXM data sheet, 900 GB/s
    # bidirectional)
    "ici_bandwidth": 450e9,
    # bytes: HBM capacity (NVIDIA H100 SXM data sheet, 80 GB)
    "hbm_bytes": 80e9,
}


def _grid(shape: tuple[int, ...], axes: tuple[str, ...], devices) -> Mesh:
    """``shape`` positions over ``devices`` (row-major; repeats allowed),
    or distinct cards ``cuda:0`` ... when ``devices`` is None, too few
    cards raising: a requested mesh is never folded onto fewer cards."""
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    n = int(np.prod(shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {shape} mesh of distinct cards needs {n} CUDA devices, "
                f"{have} available; pass devices= to place positions on "
                f"repeated devices explicitly")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh takes {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def make_local_mesh(data: int = 1, model: int = 1, *, devices=None) -> Mesh:
    """A ``(data, model)`` mesh.

    With no ``devices``, the positions are distinct cards ``cuda:0`` ..
    ``cuda:{data * model - 1}``, and too few cards raise.  ``devices``
    lists one device a position, row-major over (data, model); repeats are
    allowed there and only there (eight ``"cpu"`` positions for tests,
    eight ``cuda:0`` positions on a one-card machine).  Mixed device types
    raise."""
    return _grid((data, model), ("data", "model"), devices)


def make_position_mesh(pairs, device) -> Mesh:
    """A mesh of positions all on one ``device``: ``pairs`` of (axis,
    size), e.g. ``(("pod", 2), ("data", 2), ("model", 2))`` on ``"cpu"``
    or ``"cuda:0"``, the LM's mesh on one physical device."""
    shape = tuple(int(n) for _, n in pairs)
    return _grid(shape, tuple(a for a, _ in pairs),
                 [device] * int(np.prod(shape)))


def make_production_mesh(multi_pod: bool = False, *, devices=None) -> Mesh:
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``.  Without
    ``devices`` it needs that many distinct cards and raises otherwise, as
    ``make_local_mesh`` does; ``devices`` (one a position, repeats
    allowed) places it explicitly."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, devices)
