"""gemma3-27b [dense] — 5:1 local:global sliding-window attention, 128k ctx.

[hf:google/gemma-3-1b-pt family card, 27B variant]: 62 layers, d_model 5376,
32 heads (GQA kv=16, head_dim 128), d_ff 21504 (GeGLU), vocab 262144,
pattern = 5 sliding-window (1024) layers : 1 global layer.
Sliding-window makes it long_500k-eligible.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    ffn_kind="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_context_ok=True,
    source="hf:google/gemma-3-1b-pt (27B config)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, window=32,
        block_pattern=("local", "global"),
    )
