"""deepseek-v2-lite — the paper's backbone.

[arXiv:2405.04434 (Lite variant), paper §4.1.1]: 27 layers (first dense),
d_model 2048, 16 heads, MLA kv_lora 512 / rope 64 / nope 128 / v 128 with a
direct (uncompressed) q projection, 64 routed experts top-6 + 2 shared,
expert d_ff 1408, dense d_ff 10944, vocab 102400. 15.7B total / 2.4B active.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    block_pattern=("mla",),
    mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared=2,
        d_ff_expert=1408,
        first_dense_layers=1,
        d_ff_dense=10944,
    ),
    rope_theta=10_000.0,
    long_context_ok=False,
    source="arXiv:2405.04434 (Lite); paper §4.1.1",
)


def reduced() -> ModelConfig:
    """The small backbone the CPU tests run (same as the reference's)."""
    return CONFIG.replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=32, rope_head_dim=16,
                      nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(num_experts=16, top_k=2, num_shared=1, d_ff_expert=128,
                      first_dense_layers=1, d_ff_dense=256,
                      router_aux_coef=0.002),
    )
