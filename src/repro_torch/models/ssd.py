"""Mamba-2 block with the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060), in the reference's layouts.

Within a chunk the mixing is an attention-like masked-decay product: the
port computes it, ``y_diag``, through ``kernels.ssd_chunk`` (the CUDA
kernel on the card, its plain version on the CPU), where the reference
model writes an einsum. The chunk end states, the chunk-to-chunk
recurrence, ``y_off``, the D skip, the gate, the norm and the projections
are plain torch. Decode is a single O(1) state update.

The causal convolution is the reference's shift-and-add over ``d_conv``
taps, not ``F.conv1d``: cuDNN would run a float32 convolution in TF32 on
the card, which the card-vs-CPU parity check cannot afford.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_chunk
from repro_torch.models.common import dense_init, rms_norm, rms_norm_init


def ssd_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, nheads, conv_dim


def ssd_init(gen: torch.Generator, cfg, dtype, device):
    """The reference's tree; ``dt_bias``, ``A_log`` and ``D`` stay float32
    whatever the model's dtype."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = ssd_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.d_state + nheads
    f32 = torch.float32
    w_in = dense_init(gen, d, d_in_proj, dtype, device)
    conv_w = (torch.randn((s.d_conv, conv_dim), generator=gen, dtype=f32,
                          device=gen.device) * 0.1).to(device=device,
                                                       dtype=dtype)
    w_out = dense_init(gen, d_inner, d, dtype, device)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nheads,), dtype=f32, device=device),
        "A_log": torch.zeros((nheads,), dtype=f32, device=device),  # A = -1
        "D": torch.ones((nheads,), dtype=f32, device=device),
        "norm": rms_norm_init(d_inner, dtype, device),
        "w_out": w_out,
    }


def _causal_conv_full(x, w, b):
    """Depthwise causal conv along time. x (B,T,C); w (K,C)."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + t] * w[i]
    return out + b


def _split_in(cfg, zxbcdt):
    s = cfg.ssm
    d_inner, nheads, _ = ssd_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, s.d_state, s.d_state,
                                nheads], dim=-1)


def ssd_apply_full(p, cfg, x, return_state: bool = False):
    """x (B,T,D) -> (B,T,D); chunked SSD over the full sequence. With
    ``return_state`` also returns the decode state after position T-1
    (padding is dt = 0 and x = 0, so it leaves the state as it is)."""
    s = cfg.ssm
    b, t, _ = x.shape
    d_inner, nheads, _ = ssd_dims(cfg)
    hp, n = s.headdim, s.d_state

    z, xc, B, C, dt = _split_in(cfg, x @ p["w_in"])
    conv_in = torch.cat([xc, B, C], -1)
    xbc = F.silu(_causal_conv_full(conv_in, p["conv_w"], p["conv_b"]))
    xc, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,T,H)
    A = -torch.exp(p["A_log"])                                  # (H,)
    xh = xc.reshape(b, t, nheads, hp).float()
    Bf, Cf = B.float(), C.float()                               # (B,T,N)

    # pad T to a multiple of the chunk length
    l = s.chunk
    pad = (-t) % l
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = xh.shape[1] // l

    xch = xh.reshape(b, nc, l, nheads, hp)
    Bch = Bf.reshape(b, nc, l, n)
    Cch = Cf.reshape(b, nc, l, n)
    dtc = dt.reshape(b, nc, l, nheads)
    a_cum = torch.cumsum(dtc * A, dim=2)                        # (B,nc,L,H)

    # within-chunk (diagonal) term: the ssd_chunk kernel, one tile per
    # (chunk, head), C and B shared across heads
    xdt = xch * dtc[..., None]                                  # (B,nc,L,H,P)
    y_diag = ssd_chunk.ssd_chunk(
        Cch.reshape(b * nc, l, n).contiguous(),
        Bch.reshape(b * nc, l, n).contiguous(),
        xdt.permute(0, 1, 3, 2, 4).reshape(b * nc, nheads, l, hp)
        .contiguous(),
        a_cum.permute(0, 1, 3, 2).reshape(b * nc, nheads, l).contiguous())
    y_diag = y_diag.reshape(b, nc, nheads, l, hp).permute(0, 1, 3, 2, 4)

    # per-chunk end states and the chunk-to-chunk recurrence
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)       # (B,nc,L,H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bch,
                          decay_states * dtc, xch)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                 # (B,nc,H)
    h = torch.zeros((b, nheads, hp, n), dtype=torch.float32, device=x.device)
    h_prev = []
    for ci in range(nc):                 # emits the state BEFORE chunk ci
        h_prev.append(h)
        h = chunk_decay[:, ci, :, None, None] * h + states[:, ci]
    h_prev = torch.stack(h_prev, dim=1)                         # (B,nc,H,P,N)

    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cch, h_prev,
                         torch.exp(a_cum))
    y = (y_diag + y_off).reshape(b, nc * l, nheads, hp)[:, :t]
    y = y + p["D"][None, None, :, None] * xh[:, :t]
    y = y.reshape(b, t, d_inner).to(x.dtype)

    y = y * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if not return_state:
        return out
    # decode state after position T-1: SSD carry + last d_conv-1 conv inputs
    kc = s.d_conv - 1
    tail = conv_in[:, max(0, t - kc): t]
    if t < kc:
        tail = F.pad(tail, (0, 0, kc - t, 0))
    return out, {"h": h, "conv": tail.to(x.dtype)}


def ssd_init_state(cfg, batch: int, dtype, device):
    s = cfg.ssm
    _, nheads, conv_dim = ssd_dims(cfg)
    return {
        "h": torch.zeros((batch, nheads, s.headdim, s.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def ssd_step(p, cfg, x, state):
    """x (B,1,D); the O(1) recurrent update. Returns (y, new state)."""
    s = cfg.ssm
    b = x.shape[0]
    d_inner, nheads, _ = ssd_dims(cfg)
    hp, n = s.headdim, s.d_state

    z, xc, B, C, dt = _split_in(cfg, x @ p["w_in"])
    xbc = torch.cat([xc, B, C], -1)[:, 0]                       # (B,conv_dim)
    conv_buf = torch.cat([state["conv"], xbc[:, None]], dim=1)
    out = torch.einsum("bkc,kc->bc", conv_buf, p["conv_w"]) + p["conv_b"]
    xc, B, C = torch.split(F.silu(out), [d_inner, n, n], dim=-1)

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])            # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                      # (B,H)
    xh = xc.reshape(b, nheads, hp).float()
    Bf, Cf = B.float(), C.float()                               # (B,N)

    h = state["h"] * dA[:, :, None, None] + \
        torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bf)
    y = torch.einsum("bhpn,bn->bhp", h, Cf) + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(x.dtype)

    y = y * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], {"h": h, "conv": conv_buf[:, 1:]}
