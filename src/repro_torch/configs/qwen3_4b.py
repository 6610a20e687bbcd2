"""qwen3-4b [dense]: GQA kv=8, qk_norm."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, vocab=151936,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728,
    qk_norm=True,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, remat="none")
