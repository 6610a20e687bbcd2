"""musicgen-large [audio]: decoder-only over EnCodec tokens; the EnCodec
frontend is a stub — input_specs supplies precomputed frame embeddings
(arXiv:2306.05284)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="dense",
    n_layers=48, d_model=2048, vocab=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192,
    frontend="audio", frontend_prefix=256,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=128, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, frontend_prefix=8, remat="none")
