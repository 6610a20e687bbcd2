"""deepseek-v2-236b [moe]: MLA kv_lora=512, 2 shared + 160 routed top-6
(arXiv:2405.04434)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, vocab=102400,
    n_heads=128, n_kv_heads=128, d_ff=12288,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    first_dense_layers=1,
    q_lora=1536, kv_lora=512, rope_head_dim=64, nope_head_dim=128,
    v_head_dim=128,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256, n_heads=4, d_ff=128,
        n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=32,
        first_dense_layers=1, q_lora=32, kv_lora=32, rope_head_dim=8,
        nope_head_dim=16, v_head_dim=16, remat="none")
