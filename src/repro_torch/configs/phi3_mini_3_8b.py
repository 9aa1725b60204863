"""phi3-mini-3.8b [dense] — RoPE + SwiGLU + GQA (kv == heads, i.e. MHA).

[arXiv:2404.14219]: 32 layers, d_model 3072, 32 heads (kv=32, head_dim 96),
d_ff 8192, vocab 32064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    block_pattern=("global",),
    rope_theta=10_000.0,
    long_context_ok=False,
    source="arXiv:2404.14219",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512,
    )
