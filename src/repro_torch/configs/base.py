"""Model/config system: every assigned architecture is a ``ModelConfig``.

The counterpart of ``repro/configs/base.py``, copied so that the port
imports nothing of the reference package.

Shapes (assigned per-arch input-shape set):
  train_4k    : seq 4096,   global_batch 256  -> train_step
  prefill_32k : seq 32768,  global_batch 32   -> prefill (forward, KV out)
  decode_32k  : KV 32768,   global_batch 128  -> serve_step (1 new token)
  long_500k   : KV 524288,  global_batch 1    -> serve_step (sub-quadratic only)
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // num_heads
    qkv_bias: bool = False
    sliding_window: int = 0    # 0 = full attention
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "swiglu"        # swiglu | gelu
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba1: ssm_version=1; mamba2/SSD: ssm_version=2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1
    # hybrid (zamba2): one shared attention block applied every `attn_every`
    attn_every: int = 0
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stub: precomputed embeddings appended to the token seq
    frontend: str = "none"     # none | patches | frames
    frontend_len: int = 0      # patches/frames per example
    # numerics / training
    dtype: str = "bfloat16"
    remat: str = "dots"        # none | dots | full
    use_adafactor: bool = False  # 1T-param configs: factored 2nd moment
    # perf variants (section Perf hillclimbs)
    pad_heads_to: int = 0      # TP head alignment (0 = off)
    attn_block: int = 0        # blocked-attention tile (0 = default)
    moe_ep_axis: str = ""      # constrain expert buffers to this mesh axis
    moe_cap_factor_override: float = 0.0  # >0: capacity-factor hillclimb

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 16)

    def param_count(self) -> int:
        """Exact parameter count from the model's spec tree."""
        from ..models import transformer as _T
        from ..models.params import count_params as _cp
        return _cp(_T.model_spec(self))

    def _analytic_param_count(self) -> int:
        """Analytic estimate (weight matrices only; norms/router/bias
        excluded) — used as a cross-check in tests."""
        d, hd = self.d_model, self.hd
        attn = d * self.num_heads * hd * 2 + d * self.num_kv_heads * hd * 2
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.act == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family == "moe":
            moe = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            layer = attn + moe
        elif self.family == "ssm":
            di, n, dtr = self.d_inner, self.ssm_state, self.dt_rank
            layer = (d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * n)
                     + dtr * di + di * n + di + di * d)
        elif self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            mamba = (d * 2 * di + di * self.ssm_conv + di * (self.dt_rank + 2 * n)
                     + self.dt_rank * di + di * n + di + di * d)
            shared = attn + mlp  # one shared block, counted once below
            layer = mamba
            extra = shared
            n_emb = 2 * self.vocab_size * d if not self.tie_embeddings else self.vocab_size * d
            return self.num_layers * layer + extra + n_emb
        else:
            layer = attn + mlp
        n_layers = self.num_layers + self.encoder_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        cross = attn if self.encoder_layers else 0
        return n_layers * layer + self.num_layers * cross + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        total = self.param_count()
        if self.family != "moe":
            return total
        d = self.d_model
        moe_all = self.num_layers * self.num_experts * 3 * d * self.d_ff
        moe_active = self.num_layers * self.num_experts_per_tok * 3 * d * self.d_ff
        return total - moe_all + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
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


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k only for sub-quadratic attention (DESIGN.md section 5)."""
    if shape.name != "long_500k":
        return True
    return (cfg.family in ("ssm", "hybrid")) or cfg.sliding_window > 0
