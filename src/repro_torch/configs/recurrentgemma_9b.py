"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU + local attention, 1:2 ratio.

[arXiv:2402.19427]: 38 layers, d_model 4096, 16 heads (MQA kv=1,
head_dim 256), d_ff 12288 (GeGLU), vocab 256000, pattern = 2 recurrent
(RG-LRU) blocks : 1 local-attention (window 2048) block.
Recurrent state is O(1) in sequence length -> long_500k-eligible.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    ffn_kind="geglu",
    rglru=RGLRUConfig(lru_width=4096, d_conv=4),
    rope_theta=10_000.0,
    tie_embeddings=True,
    long_context_ok=True,
    source="arXiv:2402.19427",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=1, head_dim=64,
        d_ff=512, vocab_size=512, window=32,
        block_pattern=("rglru", "local"),
        rglru=RGLRUConfig(lru_width=256, d_conv=4),
    )
