"""PyTorch + CUDA port of the in-database decision-forest inference system.

Module paths mirror the JAX reference package ``repro`` one for one
(``repro/db/query.py`` -> ``repro_torch/db/query.py``).  The port imports
torch and never jax, and nothing of ``repro``.

Devices: every entry point (``TensorBlockStore(device=...)``,
``Forest.to(device)``, the kernel wrappers) runs on ``cuda`` unless the
caller passes ``device="cpu"``.  With no card and no explicit ``"cpu"`` they
raise: nothing quietly falls back to the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["default_device", "resolve_device", "__version__"]


def default_device() -> torch.device:
    """The card, or an error when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run the plain "
            "PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card (raising without one); an explicit device is
    taken as given, and an explicit CUDA device still needs a card."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        default_device()
    return dev
