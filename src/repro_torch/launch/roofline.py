"""Analytic roofline terms the serving engines price modeled work with.

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
