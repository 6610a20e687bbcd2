"""Model configuration dataclass shared by every architecture, and the
input-shape cells.

A copy of the reference's ``ModelConfig`` and ``ShapeConfig``/``SHAPES``:
the port reads the same fields, so a config names one model in both
packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    # dense mlp
    d_ff: int = 0
    # MoE (+ MLA) — deepseek/kimi family
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    q_lora: int = 0                  # 0 = plain q projection
    kv_lora: int = 0                 # >0 = MLA compressed kv
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid: one shared attention block applied every k ssm blocks
    attn_every: int = 0
    # modality frontend: backbone consumes precomputed embeddings
    frontend: str = "none"           # none | audio | vision
    frontend_prefix: int = 0         # prefix embedding positions (vlm)
    # serving / training limits
    max_seq: int = 532_480
    # numerics
    param_dtype: str = "bfloat16"
    # attention chunking for long prefill (online softmax block)
    attn_chunk: int = 512
    # remat policy for training: none | block
    remat: str = "block"
    # attention flavour is derived: mla if kv_lora else gqa
    sub_quadratic: bool = False      # SSM/hybrid: supports 500k decode

    @property
    def attn_type(self) -> str:
        if self.family == "ssm":
            return "none"
        return "mla" if self.kv_lora else "gqa"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def vocab_padded(self, mult: int = 128) -> int:
        return ((self.vocab + mult - 1) // mult) * mult

    def heads_padded(self, shards: int) -> int:
        """Q-heads padded up to a multiple of the TP axis (zero extra heads)."""
        if self.n_heads == 0:
            return 0
        return ((self.n_heads + shards - 1) // shards) * shards

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        total = 2 * V * d  # embed + unembed
        if self.family in ("dense",):
            hd = self.head_dim
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
            mlp = 3 * d * self.d_ff
            total += L * (attn + mlp + 2 * d)
        elif self.family == "moe":
            attn = self._mla_params()
            dense_mlp = 3 * d * self.d_ff
            moe_mlp = 3 * d * self.moe_d_ff * (
                self.n_experts + self.n_shared_experts) + d * self.n_experts
            nd = self.first_dense_layers
            total += nd * (attn + dense_mlp + 2 * d)
            total += (L - nd) * (attn + moe_mlp + 2 * d)
        elif self.family == "ssm":
            total += L * (self._ssm_params() + d)
        elif self.family == "hybrid":
            total += L * (self._ssm_params() + d)
            hd = self.head_dim
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d
            total += attn  # one shared block
        return total

    def _mla_params(self) -> int:
        d, H = self.d_model, self.n_heads
        qh = self.nope_head_dim + self.rope_head_dim
        if self.q_lora:
            q = d * self.q_lora + self.q_lora * H * qh
        else:
            q = d * H * qh
        kv = d * (self.kv_lora + self.rope_head_dim) + self.kv_lora * H * (
            self.nope_head_dim + self.v_head_dim)
        o = H * self.v_head_dim * d
        return q + kv + o

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        G, N, H = self.ssm_groups, self.ssm_state, self.ssm_heads
        in_proj = d * (2 * di + 2 * G * N + H)
        conv = (di + 2 * G * N) * self.ssm_conv
        out = di * d
        return in_proj + conv + out + 2 * H + di

    def active_param_count(self) -> int:
        """Activated params per token (= total for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        attn = self._mla_params()
        dense_mlp = 3 * d * self.d_ff
        act_mlp = 3 * d * self.moe_d_ff * (self.top_k + self.n_shared_experts) \
            + d * self.n_experts
        nd = self.first_dense_layers
        total = 2 * self.vocab * d
        total += nd * (attn + dense_mlp + 2 * d)
        total += (L - nd) * (attn + act_mlp + 2 * d)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
