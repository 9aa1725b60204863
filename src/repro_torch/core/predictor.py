"""The MoE-Beyond expert-activation predictor (paper §3.2), inference only.

concat(standardised token_emb, layer_emb[layer_id]) -> linear(d_model) ->
pre-LN transformer encoder (causal + padding mask) -> 2-layer GELU head ->
num_experts * horizon logits. Dropout is a training-time op and absent;
training the predictor is ROADMAP work ("tracing and predictor
training"). Parameters: the reference's tree with ``enc`` as a list of
per-layer dicts (``convert.predictor_from_jax`` unstacks it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PredictorConfig
from repro_torch.kernels.runtime import resolve_device

NEG_INF = -1e30


def _ln(x, g, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def predictor_init(generator, pc: PredictorConfig, device="cuda"):
    dev = resolve_device(device)
    gen = generator
    d, ff, e = pc.d_model, pc.d_ff, pc.num_experts

    def dense(i, o):
        return (torch.randn((i, o), generator=gen, device=gen.device)
                * (i ** -0.5)).to(dev)

    def zeros(n):
        return torch.zeros((n,), device=dev)

    enc = [{
        "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wo": dense(d, d),
        "ln1_g": torch.ones((d,), device=dev), "ln1_b": zeros(d),
        "w1": dense(d, ff), "b1": zeros(ff),
        "w2": dense(ff, d), "b2": zeros(d),
        "ln2_g": torch.ones((d,), device=dev), "ln2_b": zeros(d),
    } for _ in range(pc.num_layers)]
    return {
        "layer_emb": (torch.randn((pc.num_model_layers, pc.layer_emb_dim),
                                  generator=gen, device=gen.device)
                      * 0.02).to(dev),
        "in_w": dense(pc.token_emb_dim + pc.layer_emb_dim, d),
        "in_b": zeros(d),
        "enc": enc,
        "head_w0": dense(d, d), "head_b0": zeros(d),
        "head_w1": dense(d, e * pc.horizon),
        "head_b1": zeros(e * pc.horizon),
    }


@torch.no_grad()
def predictor_apply(params, pc: PredictorConfig, emb, layer_ids, pad_mask):
    """emb (B,T,token_emb_dim) f32; layer_ids (B,T) int; pad_mask (B,T)
    bool (True = real token). Returns logits (B,T,E*horizon)."""
    b, t, _ = emb.shape
    h = pc.num_heads
    dh = pc.d_model // h

    ef = emb.float()
    mu = ef.mean(-1, keepdim=True)
    sd = ef.std(-1, keepdim=True, correction=0) + 1e-6
    ef = (ef - mu) / sd

    le = params["layer_emb"][layer_ids.long()]
    x = torch.cat([ef, le], dim=-1) @ params["in_w"] + params["in_b"]

    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=emb.device))
    mask = causal[None] & pad_mask[:, None, :]             # (B,T,T)
    neg = torch.full((), NEG_INF, device=emb.device)

    for lp in params["enc"]:
        xn = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (xn @ lp["wq"]).reshape(b, t, h, dh)
        k = (xn @ lp["wk"]).reshape(b, t, h, dh)
        v = (xn @ lp["wv"]).reshape(b, t, h, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
        s = torch.where(mask[:, None], s, neg)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, -1)
        x = x + o @ lp["wo"]
        xn = _ln(x, lp["ln2_g"], lp["ln2_b"])
        f = F.gelu(xn @ lp["w1"] + lp["b1"], approximate="tanh")
        x = x + (f @ lp["w2"] + lp["b2"])

    x = F.gelu(x @ params["head_w0"] + params["head_b0"], approximate="tanh")
    return x @ params["head_w1"] + params["head_b1"]
