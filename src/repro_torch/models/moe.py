"""MoE layer parameters, the router (softmax -> top-k -> renormalise) and
the expert half of a decode step with every expert on the device.

The routed experts' compute is ``kernels/expert_ffn.py``: the offloaded
engines hand it their slot buffer, :func:`moe_decode` the ``(E, D, F)``
expert tensors themselves. The shared experts run as a dense SwiGLU
(``models/common.ffn_apply``). The capacity-dispatch ``moe_apply`` of
training is ROADMAP work ("training and launch").
"""
from __future__ import annotations

import torch

from repro_torch.kernels.expert_ffn import expert_ffn
from repro_torch.kernels.topk_gating import topk_gating
from repro_torch.models.common import dense_init, ffn_apply, ffn_init


def moe_init(gen, cfg, dtype, device, expert_device=None):
    """Router weights are float32 whatever the model dtype. The routed
    experts ``(E, D, F)``/``(E, F, D)`` are drawn on the generator's device
    and placed on ``expert_device`` (default ``device``) — the offloaded
    engine keeps them in host memory."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    expert_device = device if expert_device is None else expert_device

    def experts(d_in, d_out, shape):
        w = dense_init(gen, d_in, d_out, dtype, gen.device).reshape(shape)
        if torch.device(expert_device).type == "cpu" \
                and torch.cuda.is_available():
            host = torch.empty(shape, dtype=dtype, pin_memory=True)
            return host.copy_(w)
        return w.to(expert_device)

    p = {
        "w_router": dense_init(gen, d, e, torch.float32, device),
        "w_gate": experts(d, e * f, (e, d, f)),
        "w_up": experts(d, e * f, (e, d, f)),
        "w_down": experts(f, e * d, (e, f, d)),
    }
    if m.num_shared:
        p["shared"] = ffn_init(gen, d, m.num_shared * f, dtype, device)
    return p


def route(p, cfg, x):
    """Router: float32 logits, then the ``topk_gating`` kernel.

    x (B, T, D) -> (weights (B, T, k) f32, idx (B, T, k) int32)."""
    b, t, d = x.shape
    logits = x.reshape(b * t, d).float() @ p["w_router"]
    w, idx = topk_gating(logits.contiguous(), cfg.moe.top_k)
    return w.reshape(b, t, -1), idx.reshape(b, t, -1)


def moe_decode(p, cfg, x):
    """Routed plus shared experts of decode tokens whose experts all live
    on ``x``'s device: the reference's ``moe_apply(decode=True)``, whose
    capacity ``ceil(k * capacity_factor / E)`` per token drops nothing at
    batch 1. The ``(E, D, F)`` expert tensors are their own slot buffer,
    so the routed ids are the slot ids of ``expert_ffn``.

    x (B, T, D) -> (y (B, T, D), routed ids (B, T, k) int32)."""
    b, t, d = x.shape
    w, idx = route(p, cfg, x)
    y = expert_ffn(x.reshape(b * t, d).contiguous(),
                   w.reshape(b * t, -1).to(x.dtype).contiguous(),
                   idx.reshape(b * t, -1).contiguous(),
                   p["w_gate"], p["w_up"], p["w_down"]).reshape(b, t, d)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, "swiglu")
    return y, idx
