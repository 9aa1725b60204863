"""llama4-scout-17b-a16e [moe] — MoE with early fusion, chunked attention.

[hf:meta-llama/Llama-4-Scout-17B-16E]: 48 layers, d_model 5120, 40 heads
(GQA kv=8, head_dim 128), d_ff 8192, vocab 202048, 16 routed experts top-1
plus one shared expert; 3:1 chunked-local (iRoPE, 8192 chunk) : global
attention, which makes it long_500k-eligible.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("chunked", "chunked", "chunked", "global"),
    chunk=8192,
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        num_shared=1,
        d_ff_expert=8192,
        capacity_factor=2.0,  # top-1 routing needs slack
    ),
    frontend="vision",
    frontend_dim=1408,
    frontend_len=256,
    rope_theta=500_000.0,
    long_context_ok=True,   # chunked local attention (iRoPE)
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, chunk=64,
        block_pattern=("chunked", "global"),
        moe=MoEConfig(num_experts=4, top_k=1, num_shared=1, d_ff_expert=256,
                      capacity_factor=2.0),
        frontend_dim=128, frontend_len=16,
    )
