"""Shared building blocks: init helpers, RMSNorm, RoPE, the gated FFN.

Plain functions over dicts of tensors, with the reference's layouts
(weights ``(d_in, d_out)``). Inits draw from an explicit
``torch.Generator`` on the generator's device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return w.to(device=device, dtype=dtype)


def rms_norm_init(dim: int, dtype, device) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


def rms_norm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-rotation / llama convention)

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * inv               # (..., T, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., T, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense gated FFN (SwiGLU)

def ffn_init(gen, d_model: int, d_ff: int, dtype, device):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def ffn_apply(p, x, kind: str = "swiglu"):
    if kind != "swiglu":
        raise NotImplementedError(
            f"ffn_kind {kind!r} (ROADMAP: GQA/local/chunked attention and "
            "the other architectures)")
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]
