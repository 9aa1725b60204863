"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

[arXiv:2308.11596]: 24-layer decoder, d_model 1024, 16 heads (kv=16,
head_dim 64), d_ff 8192, vocab 256206; 24-layer encoder over audio frame
embeddings. The mel-spectrogram + conformer feature extractor is a stub, as
in the reference: the model reads precomputed frame embeddings
(``batch["frames"]``, ``frontend_len`` x ``frontend_dim``).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    block_pattern=("global",),
    encdec=EncDecConfig(enc_layers=24, enc_heads=16, enc_d_ff=8192),
    frontend="audio",
    frontend_dim=1024,
    frontend_len=512,        # audio frames per example
    rope_theta=10_000.0,
    long_context_ok=False,   # full attention decoder -> skip long_500k
    source="arXiv:2308.11596",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512,
        encdec=EncDecConfig(enc_layers=2, enc_heads=4, enc_d_ff=512),
        frontend_dim=128, frontend_len=32,
    )
