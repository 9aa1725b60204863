"""Griffin recurrent block: causal conv + Real-Gated LRU (arXiv:2402.19427),
in the reference's layouts (``models/rglru.py``).

The RG-LRU is a per-channel linear recurrence ``h_t = a_t h_{t-1} + b_t``.
Over a whole sequence it runs as a log-depth scan (:func:`linear_scan`:
Hillis-Steele doubling, ceil(log2 T) out-of-place elementwise steps,
differentiable by autograd), as the reference's ``associative_scan`` does,
never as a Python loop over T. The scan sums in another order than JAX's,
so the two agree within a float32 tolerance, not bit for bit. Decode is a
single O(1) update. The causal conv is :func:`common.causal_conv_full`
(shift-and-add, no cuDNN); the gate's GELU is the tanh form, as
``jax.nn.gelu``'s default. The reference writes this block in plain JAX,
with no Pallas kernel, so it is plain PyTorch here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import causal_conv_full, dense_init

_C = 8.0  # RG-LRU gate exponent constant (Griffin §2.4)


def rglru_width(cfg) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_init(gen: torch.Generator, cfg, dtype, device):
    """The reference's tree; ``lam`` stays float32 whatever the model's
    dtype."""
    w, d = rglru_width(cfg), cfg.d_model
    f32 = torch.float32
    return {
        "w_x": dense_init(gen, d, w, dtype, device),      # recurrent branch in
        "w_gate": dense_init(gen, d, w, dtype, device),   # gelu gate branch in
        "conv_w": (torch.randn((cfg.rglru.d_conv, w), generator=gen,
                               dtype=f32, device=gen.device) * 0.1).to(
            device=device, dtype=dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "w_i": dense_init(gen, w, w, dtype, device),      # input gate
        "w_r": dense_init(gen, w, w, dtype, device),      # recurrence gate
        "lam": torch.full((w,), 4.0, dtype=f32, device=device),  # a ~ .982
        "w_out": dense_init(gen, w, d, dtype, device),
    }


def _gates(p, xr):
    """xr (..., W), the conv output -> (a, gated input b), both float32."""
    i = torch.sigmoid((xr @ p["w_i"]).float())
    r = torch.sigmoid((xr @ p["w_r"]).float())
    log_a = -_C * r * F.softplus(p["lam"])               # log a_t (<= 0)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i * xr.float()


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: the inclusive
    scan of the reference's ``combine`` ((a1, b1), (a2, b2)) -> (a1 a2,
    a2 b1 + b2), by Hillis-Steele doubling: step ``s`` folds in the
    element ``s`` places back (the identity (1, 0) before the start).
    a, b (B, T, ...) -> h (B, T, ...)."""
    t, s = a.shape[1], 1
    while s < t:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def _gate_branch(p, x):
    return F.gelu(x @ p["w_gate"], approximate="tanh")


def rglru_apply_full(p, cfg, x, return_state: bool = False):
    """x (B,T,D) -> (B,T,D); with ``return_state`` also the decode state
    after position T-1: ``h`` of the last position and the conv's last
    ``d_conv - 1`` inputs (zero-padded in front when T is shorter)."""
    xw = x @ p["w_x"]
    xr = causal_conv_full(xw, p["conv_w"], p["conv_b"])
    a, b = _gates(p, xr)                                 # (B,T,W) f32
    h = linear_scan(a, b)
    out = (h.to(x.dtype) * _gate_branch(p, x)) @ p["w_out"]
    if not return_state:
        return out
    kc, t = cfg.rglru.d_conv - 1, x.shape[1]
    tail = xw[:, max(0, t - kc):]
    if t < kc:
        tail = F.pad(tail, (0, 0, kc - t, 0))
    return out, {"h": h[:, -1], "conv": tail.to(x.dtype)}


def rglru_init_state(cfg, batch: int, dtype, device):
    w = rglru_width(cfg)
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rglru.d_conv - 1, w),
                                dtype=dtype, device=device)}


def rglru_step(p, cfg, x, state):
    """x (B,1,D) -> (y (B,1,D), new state); the O(1) update."""
    xw = (x @ p["w_x"])[:, 0]                            # (B,W)
    conv_buf = torch.cat([state["conv"], xw[:, None]], dim=1)
    xr = torch.einsum("bkw,kw->bw", conv_buf, p["conv_w"]) + p["conv_b"]
    a, b = _gates(p, xr)
    h = a * state["h"] + b
    y = (h.to(x.dtype) * _gate_branch(p, x)[:, 0]) @ p["w_out"]
    return y[:, None], {"h": h, "conv": conv_buf[:, 1:]}
