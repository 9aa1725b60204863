"""Analytic roofline terms the serving engines price modeled work with:
the compute clock's per-layer halves (:func:`decode_layer_roofline`) and
the ship half of compute dispatch (:func:`expert_ffn_roofline`).

The reference derives them in ``launch/dryrun.py`` with TPU v5e defaults
(``launch/mesh.py``); here every caller states the device's peak rate and
memory bandwidth, so no TPU figure can stand in for the card's.
"""
from __future__ import annotations

import torch


def expert_ffn_roofline(cfg, *, peak_flops: float, hbm_bw: float):
    """``(per_token_s, base_s)`` of ONE routed expert's SwiGLU FFN
    computed remotely (the ship half of the fetch-vs-ship choice,
    ``serving/expertstore.DispatchPlanner``): ``per_token_s`` is the
    matvec's operations, ``2 * 3*d*d_ff_expert / peak_flops`` a token;
    ``base_s`` the token-independent read of the expert's weights,
    ``3*d*d_ff_expert * itemsize / hbm_bw``."""
    m = cfg.moe
    if m is None:
        raise ValueError("expert_ffn_roofline needs an MoE config")
    per = 3 * cfg.d_model * m.d_ff_expert
    dt = getattr(torch, cfg.dtype).itemsize
    return 2 * per / peak_flops, per * dt / hbm_bw


def _attn_layer_params(cfg, kind: str) -> int:
    """Weights of one layer's attention (or recurrent) half, the
    reference's counts as they stand, omissions kept so that the port's
    per-layer terms equal the reference's exactly: for ``mla`` with
    ``q_lora_rank`` 0 (DeepSeek-V2-Lite) the ``q_lora_rank`` terms are 0
    and the direct ``w_q`` (D x H x qk) is counted nowhere; for ``rglru``,
    ``2*d*w + 3*w + w*d`` leaves out the gates ``w_i``/``w_r`` (2 w^2) and
    ``conv_w``."""
    d, hd = cfg.d_model, cfg.hd
    if kind == "mla":
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        return (d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk
                + d * (m.kv_lora_rank + m.rope_head_dim)
                + m.kv_lora_rank * cfg.num_heads * (m.nope_head_dim
                                                    + m.v_head_dim)
                + cfg.num_heads * m.v_head_dim * d)
    if kind == "ssd":
        s = cfg.ssm
        di = s.expand * d
        return d * (2 * di + 2 * s.d_state + di // s.headdim) + di * d
    if kind == "rglru":
        w = cfg.rglru.lru_width or d
        return 2 * d * w + 3 * w + w * d
    return (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
            + cfg.num_heads * hd * d)


def _kv_read_positions(cfg, kind: str, cache_len: int) -> int:
    if kind == "local":
        return min(cache_len, cfg.window)
    if kind == "chunked":
        return min(cache_len, cfg.chunk)
    if kind in ("rglru", "ssd"):
        return 0                     # bounded recurrent state, not a KV scan
    return cache_len


def decode_layer_roofline(cfg, batch: int = 1, cache_len: int = 1024, *,
                          peak_flops: float, hbm_bw: float):
    """Per-layer ``(attn_s, ffn_s)`` of ONE decode step of ``batch`` lanes
    over ``cache_len`` positions, each half ``max(operations / peak_flops,
    bytes / hbm_bw)``: matvec operations over the half's weights plus the
    attention KV scan; bytes of the weights plus the KV read. An MoE
    layer's FFN streams its ``min(batch * top_k, E)`` distinct routed
    experts, the shared ones and the router once. ``DecodeCore``'s
    ``"roofline"`` clock advances by these terms; ``"measured"`` rescales
    them to the step's wall time."""
    dt = getattr(torch, cfg.dtype).itemsize
    d = cfg.d_model
    out = []
    for li, kind in enumerate(cfg.layer_kinds()):
        ap = _attn_layer_params(cfg, kind)
        kv_pos = _kv_read_positions(cfg, kind, cache_len)
        if kind == "mla":
            m = cfg.mla
            qk_dim = cfg.num_heads * (m.nope_head_dim + m.rope_head_dim)
            kv_bytes = kv_pos * (m.kv_lora_rank + m.rope_head_dim) * dt
        else:
            qk_dim = cfg.num_heads * cfg.hd
            kv_bytes = kv_pos * 2 * cfg.num_kv_heads * cfg.hd * dt
        attn_flops = batch * (2 * ap + 4 * kv_pos * qk_dim)
        attn_bytes = ap * dt + batch * kv_bytes
        attn_s = max(attn_flops / peak_flops, attn_bytes / hbm_bw)

        ffn_s = 0.0
        if kind != "ssd":
            m = cfg.moe
            if m is not None and li >= m.first_dense_layers:
                per = 3 * d * m.d_ff_expert
                active = (m.top_k + m.num_shared) * per + d * m.num_experts
                ffn_flops = 2 * active * batch
                ffn_bytes = (min(batch * m.top_k, m.num_experts)
                             + m.num_shared) * per * dt \
                    + d * m.num_experts * dt
            else:
                dff = cfg.d_ff
                if m is not None and m.d_ff_dense:
                    dff = m.d_ff_dense
                ffn_flops = 2 * 3 * d * dff * batch
                ffn_bytes = 3 * d * dff * dt
            ffn_s = max(ffn_flops / peak_flops, ffn_bytes / hbm_bw)
        out.append((attn_s, ffn_s))
    return out
