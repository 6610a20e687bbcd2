"""qwen2.5-32b [dense]: GQA kv=8, QKV bias."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, vocab=152064,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=27648,
    qkv_bias=True,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256, n_heads=5, n_kv_heads=1,
        head_dim=16, d_ff=128, remat="none")
