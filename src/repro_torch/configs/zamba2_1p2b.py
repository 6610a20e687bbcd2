"""zamba2-1.2b [hybrid]: 38L Mamba2 + shared attention block (arXiv:2411.15242)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, vocab=32000,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    attn_every=6, sub_quadratic=True,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, vocab=128, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, ssm_state=16, ssm_head_dim=16, attn_every=2,
        ssm_chunk=8, remat="none")
