"""Architecture registry: ``arch`` -> (ModelConfig, model module).

The port runs the dense transformer (``models/transformer.py``: smollm,
qwen, the audio and vision backbones) and the MLA + MoE decoder
(``models/moe.py``: deepseek-v2, kimi-k2); the reference's SSM and hybrid
architectures raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import importlib
from typing import Tuple

_DENSE = "repro_torch.models.transformer"
_MOE = "repro_torch.models.moe"

#: ported architectures: arch -> (config module, model module)
ARCHS = {
    "kimi-k2-1t-a32b": ("repro_torch.configs.kimi_k2_1t_a32b", _MOE),
    "deepseek-v2-236b": ("repro_torch.configs.deepseek_v2_236b", _MOE),
    "qwen3-4b": ("repro_torch.configs.qwen3_4b", _DENSE),
    "qwen2-72b": ("repro_torch.configs.qwen2_72b", _DENSE),
    "qwen2.5-32b": ("repro_torch.configs.qwen2p5_32b", _DENSE),
    "smollm-360m": ("repro_torch.configs.smollm_360m", _DENSE),
    "musicgen-large": ("repro_torch.configs.musicgen_large", _DENSE),
    "internvl2-76b": ("repro_torch.configs.internvl2_76b", _DENSE),
}

#: the reference's other architectures and where their port is queued
UNPORTED = {
    "zamba2-1.2b": "ROADMAP.md Queue 1, item 1: Mamba2 and the hybrid",
    "mamba2-370m": "ROADMAP.md Queue 1, item 1: Mamba2 and the hybrid",
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
