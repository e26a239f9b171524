"""Config registry: one module per assigned architecture.

The port's own copy of ``repro/configs/``, field for field (pure data and
arithmetic; ``tests/test_torch_lm.py`` holds each config, ``reduced()`` and
the parameter counts against the reference's).  ``get_config(arch_id)``
returns the exact published configuration; ``reduced`` shrinks it for CPU
smoke tests.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      reduced)

ARCH_IDS = [
    "yi-34b",
    "olmo-1b",
    "qwen2-7b",
    "minitron-4b",
    "mamba2-2.7b",
    "llama4-scout-17b-a16e",
    "llama4-maverick-400b-a17b",
    "seamless-m4t-large-v2",
    "zamba2-2.7b",
    "chameleon-34b",
]

_MODULES = {
    "yi-34b": "yi_34b",
    "olmo-1b": "olmo_1b",
    "qwen2-7b": "qwen2_7b",
    "minitron-4b": "minitron_4b",
    "mamba2-2.7b": "mamba2_2p7b",
    "llama4-scout-17b-a16e": "llama4_scout",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "seamless-m4t-large-v2": "seamless_m4t",
    "zamba2-2.7b": "zamba2_2p7b",
    "chameleon-34b": "chameleon_34b",
}


def get_config(arch_id: str) -> ModelConfig:
    try:
        mod_name = _MODULES[arch_id]
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; options {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "get_config", "ModelConfig", "ShapeConfig", "SHAPES",
           "reduced"]
