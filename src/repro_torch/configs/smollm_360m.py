"""smollm-360m [dense]: llama-arch small (15 heads — TP pads to 16)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, vocab=49152,
    n_heads=15, n_kv_heads=5, head_dim=64, d_ff=2560,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=60, vocab=256, n_heads=3, n_kv_heads=1,
        head_dim=20, d_ff=128, remat="none")
