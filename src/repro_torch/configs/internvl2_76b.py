"""internvl2-76b [vlm]: InternLM2-76B backbone; InternViT frontend is a
stub — input_specs supplies precomputed patch embeddings
(arXiv:2404.16821)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="dense",
    n_layers=80, d_model=8192, vocab=128256,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672,
    frontend="vision", frontend_prefix=256,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, frontend_prefix=8, remat="none")
