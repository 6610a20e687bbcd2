"""qwen2-72b [dense]: GQA kv=8, QKV bias (arXiv:2407.10671)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, vocab=152064,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568,
    qkv_bias=True,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, remat="none")
