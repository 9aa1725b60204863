"""MoE layer parameters and the router (softmax -> top-k -> renormalise).

Only what the offloaded serving path runs: the routed experts' compute
reads the slot buffer (``kernels/expert_ffn.py``) and the shared experts
run as a dense SwiGLU (``models/common.ffn_apply``). The capacity-dispatch
``moe_apply`` of training is ROADMAP work ("training and launch").
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_gating import topk_gating
from repro_torch.models.common import dense_init, ffn_init


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
