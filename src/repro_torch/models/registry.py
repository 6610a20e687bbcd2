"""Architecture registry: ``arch`` -> (ModelConfig, model module).

Every architecture of the reference: the dense transformer
(``models/transformer.py``: smollm, qwen, the audio and vision backbones),
the MLA + MoE decoder (``models/moe.py``: deepseek-v2, kimi-k2), Mamba2
(``models/mamba2.py``) and the Zamba2 hybrid (``models/hybrid.py``).
"""

from __future__ import annotations

import importlib
from typing import Tuple

_DENSE = "repro_torch.models.transformer"
_MOE = "repro_torch.models.moe"

#: arch -> (config module, model module)
ARCHS = {
    "zamba2-1.2b": ("repro_torch.configs.zamba2_1p2b",
                    "repro_torch.models.hybrid"),
    "kimi-k2-1t-a32b": ("repro_torch.configs.kimi_k2_1t_a32b", _MOE),
    "deepseek-v2-236b": ("repro_torch.configs.deepseek_v2_236b", _MOE),
    "qwen3-4b": ("repro_torch.configs.qwen3_4b", _DENSE),
    "qwen2-72b": ("repro_torch.configs.qwen2_72b", _DENSE),
    "qwen2.5-32b": ("repro_torch.configs.qwen2p5_32b", _DENSE),
    "smollm-360m": ("repro_torch.configs.smollm_360m", _DENSE),
    "mamba2-370m": ("repro_torch.configs.mamba2_370m",
                    "repro_torch.models.mamba2"),
    "musicgen-large": ("repro_torch.configs.musicgen_large", _DENSE),
    "internvl2-76b": ("repro_torch.configs.internvl2_76b", _DENSE),
}


def get(arch: str, reduced: bool = False) -> Tuple[object, object]:
    """Returns (config, model_module)."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    cfg_mod, model_mod = ARCHS[arch]
    cmod = importlib.import_module(cfg_mod)
    mmod = importlib.import_module(model_mod)
    cfg = cmod.reduced() if reduced else cmod.CONFIG
    return cfg, mmod


def names():
    return sorted(ARCHS)
