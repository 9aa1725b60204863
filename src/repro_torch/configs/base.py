"""Model configuration dataclasses (copy of the reference's
``configs/base.py`` fields used by the port).

A ``ModelConfig`` fully determines an architecture; the port's model
builder (``repro_torch.models.model``) consumes only this dataclass.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

ATTN_KINDS = ("global", "local", "chunked", "mla")
RECURRENT_KINDS = ("rglru", "ssd")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int
    num_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    first_dense_layers: int = 0      # leading layers that use a dense FFN
    d_ff_dense: int = 0              # d_ff for those dense layers (0 -> cfg.d_ff)
    dispatch_group: int = 4096
    decode_gather: bool = False


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    chunk: int = 128
    d_conv: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = ("global",)
    window: int = 1024               # sliding-window size for "local"
    chunk: int = 8192                # chunk size for "chunked"
    ffn_kind: str = "swiglu"         # swiglu | geglu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[str] = None   # None | "vision" | "audio" (stubbed)
    frontend_dim: int = 1024         # dim of precomputed patch/frame embeddings
    frontend_len: int = 256          # patches/frames per example
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    long_context_ok: bool = False
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand block_pattern to num_layers entries (pattern repeats)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PredictorConfig:
    """The paper's expert-activation predictor (§3.2)."""
    token_emb_dim: int = 2048        # backbone token-embedding dim
    num_model_layers: int = 27       # backbone MoE layers (layer-id vocab)
    num_experts: int = 64            # routed experts to predict
    layer_emb_dim: int = 512
    d_model: int = 512
    num_layers: int = 4
    num_heads: int = 8
    d_ff: int = 2048
    dropout: float = 0.1
    max_seq: int = 512
    top_k: int = 6                   # experts selected at eval
    threshold: float = 0.5
    horizon: int = 1                 # layers of look-ahead

    def replace(self, **kw) -> "PredictorConfig":
        return dataclasses.replace(self, **kw)
