"""Architecture registry: ``arch`` -> (ModelConfig, model module).

The port runs the dense transformer; every other architecture of the
reference raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import importlib
from typing import Tuple

#: ported architectures: arch -> (config module, model module)
ARCHS = {
    "smollm-360m": ("repro_torch.configs.smollm_360m",
                    "repro_torch.models.transformer"),
}

#: the reference's other architectures and where their port is queued
UNPORTED = {
    "zamba2-1.2b": "ROADMAP.md Queue 1: MoE / Mamba2 / hybrid models",
    "kimi-k2-1t-a32b": "ROADMAP.md Queue 1: MoE / Mamba2 / hybrid models",
    "deepseek-v2-236b": "ROADMAP.md Queue 1: MoE / Mamba2 / hybrid models",
    "mamba2-370m": "ROADMAP.md Queue 1: MoE / Mamba2 / hybrid models",
    "qwen3-4b": "ROADMAP.md Queue 1: other model configs",
    "qwen2-72b": "ROADMAP.md Queue 1: other model configs",
    "qwen2.5-32b": "ROADMAP.md Queue 1: other model configs",
    "musicgen-large": "ROADMAP.md Queue 1: modality frontends",
    "internvl2-76b": "ROADMAP.md Queue 1: modality frontends",
}


def get(arch: str, reduced: bool = False) -> Tuple[object, object]:
    """Returns (config, model_module)."""
    if arch in UNPORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet ({UNPORTED[arch]})")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    cfg_mod, model_mod = ARCHS[arch]
    cmod = importlib.import_module(cfg_mod)
    mmod = importlib.import_module(model_mod)
    cfg = cmod.reduced() if reduced else cmod.CONFIG
    return cfg, mmod


def names():
    return sorted(ARCHS)
