"""kimi-k2-1t-a32b [moe]: trillion-param MLA MoE, 384 experts top-8."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, vocab=163840,
    n_heads=64, n_kv_heads=8, d_ff=18432,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=1,
    q_lora=1536, kv_lora=512, rope_head_dim=64, nope_head_dim=128,
    v_head_dim=128,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256, n_heads=4, d_ff=128,
        n_experts=8, top_k=2, moe_d_ff=32, first_dense_layers=1,
        q_lora=32, kv_lora=32, rope_head_dim=8, nope_head_dim=16,
        v_head_dim=16, remat="none")
