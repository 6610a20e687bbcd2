"""mamba2-370m [ssm]: SSD, attention-free (arXiv:2405.21060)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    sub_quadratic=True,
)

def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, remat="none")
