"""MoE layer parameters, the router (softmax -> top-k -> renormalise), the
capacity-factor dispatch of training and the expert half of a decode step
with every expert on the device.

The routed experts' compute at decode is ``kernels/expert_ffn.py``: the
offloaded engines hand it their slot buffer, :func:`moe_decode` the
``(E, D, F)`` expert tensors themselves. Training's :func:`moe_apply`
runs the grouped expert products as plain matrix products, as the
reference leaves them to XLA. The shared experts run as a dense SwiGLU
(``models/common.ffn_apply``). Both paths keep the reference's capacity
rule (:func:`dispatch_rank`): within a dispatch group of ``sg`` tokens an
expert takes at most ``capacity(cfg, sg)`` (token, k) pairs, in (token,
k) order, and drops the rest.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.expert_ffn import MAX_PAIRS, expert_ffn
from repro_torch.kernels.topk_gating import topk_gating
from repro_torch.launch import shardctx
from repro_torch.launch.shardctx import data_mean
from repro_torch.models.common import dense_init, ffn_apply, ffn_init

# tokens per dispatch group when the config sets none (the reference's)
DEFAULT_GROUP = 4096


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
    """Router of serving: float32 logits, then the ``topk_gating`` kernel.

    x (B, T, D) -> (weights (B, T, k) f32, idx (B, T, k) int32)."""
    b, t, d = x.shape
    logits = x.reshape(b * t, d).float() @ p["w_router"]
    w, idx = topk_gating(logits.contiguous(), cfg.moe.top_k)
    return w.reshape(b, t, -1), idx.reshape(b, t, -1)


def route_train(p, cfg, x):
    """Router of training, the reference's ``route``: the ids from the
    ``topk_gating`` kernel (lowest index on ties, as ``lax.top_k``), the
    weights gathered from a differentiable float32 softmax and
    renormalised with ``+1e-9``, so the gradient reaches ``w_router`` as
    ``jax.grad`` sends it.

    x (B, T, D) -> (weights (B, T, k) f32, idx (B, T, k) int32,
    probs (B, T, E) f32)."""
    b, t, d = x.shape
    logits = x.reshape(b * t, d).float() @ p["w_router"]
    probs = torch.softmax(logits, dim=-1)
    _, idx = topk_gating(logits.detach().contiguous(), cfg.moe.top_k)
    w = probs.gather(1, idx.long())
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return (w.reshape(b, t, -1), idx.reshape(b, t, -1),
            probs.reshape(b, t, -1))


def aux_load_balance_loss(cfg, probs, idx):
    """Switch-style load-balance loss: E * sum_e density_e * usage_e, both
    means over the whole batch inside a sharded step's data group
    (``launch/shardctx.data_parallel``)."""
    e = cfg.moe.num_experts
    density = data_mean(probs.reshape(-1, e).mean(0))           # router mass
    usage = data_mean(F.one_hot(idx.reshape(-1).long(), e).float().mean(0)
                      * (1.0 / cfg.moe.top_k))                  # token share
    return e * torch.sum(density * usage)


def capacity(cfg, group_tokens: int) -> int:
    """(token, k) pairs an expert takes from one dispatch group."""
    m = cfg.moe
    return max(1, math.ceil(group_tokens * m.top_k * m.capacity_factor
                            / m.num_experts))


def dispatch_group(cfg, n: int) -> int:
    """Tokens per dispatch group of ``n`` tokens: the config's group (or
    ``DEFAULT_GROUP``) capped at ``n``, and ``n`` itself when it does not
    divide ``n``."""
    sg = min(cfg.moe.dispatch_group or DEFAULT_GROUP, n)
    return n if n % sg else sg


def dispatch_rank(cfg, idx, sg: int):
    """Each (token, k) pair's place in its expert's queue within its
    dispatch group of ``sg`` tokens, counted in (token, k) order: idx
    (n, k) -> rank (n, k) int64. A pair is kept when its rank is below
    ``capacity(cfg, sg)`` (the reference's keep rule)."""
    n, k = idx.shape
    onehot = F.one_hot(idx.reshape(n // sg, sg * k).long(),
                       cfg.moe.num_experts)                    # (G, S*k, E)
    pos = onehot.cumsum(1) - 1
    return pos.gather(2, idx.reshape(n // sg, sg * k, 1).long()).reshape(n, k)


def moe_decode(p, cfg, x):
    """Routed plus shared experts of decode tokens whose experts all live
    on ``x``'s device: the reference's ``moe_apply(decode=True)``. The
    ``(E, D, F)`` expert tensors are their own slot buffer, so the routed
    ids are the slot ids of ``expert_ffn``. Pairs past their expert's
    capacity weigh 0 (none can drop while the capacity is at least the
    group's token count, as at batch 1), and the tokens go to
    ``expert_ffn`` in runs of at most ``MAX_PAIRS // k``.

    x (B, T, D) -> (y (B, T, D), routed ids (B, T, k) int32)."""
    b, t, d = x.shape
    n = b * t
    w, idx = route(p, cfg, x)
    w, ids = w.reshape(n, -1), idx.reshape(n, -1)
    sg = dispatch_group(cfg, n)
    c = capacity(cfg, sg)
    if c < sg:
        w = torch.where(dispatch_rank(cfg, ids, sg) < c, w, 0.0)
    w = w.to(x.dtype)
    xf = x.reshape(n, d)
    run = max(1, MAX_PAIRS // ids.shape[1])
    ys = [expert_ffn(xf[i:i + run].contiguous(), w[i:i + run].contiguous(),
                     ids[i:i + run].contiguous(), p["w_gate"], p["w_up"],
                     p["w_down"]) for i in range(0, n, run)]
    y = (ys[0] if len(ys) == 1 else torch.cat(ys)).reshape(b, t, d)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, "swiglu")
    return y, idx


def grouped_swiglu(p, x_e):
    """The grouped SwiGLU products of the capacity buffer: x_e (E', G*C,
    D) against the experts ``p["w_gate"]``/``p["w_up"]`` (E', D, F) and
    ``p["w_down"]`` (E', F, D) -> (E', G*C, D)."""
    h = F.silu(torch.bmm(x_e, p["w_gate"])) * torch.bmm(x_e, p["w_up"])
    return torch.bmm(h, p["w_down"])


def moe_apply(p, cfg, x, resid=None):
    """The training forward of the reference's ``moe_apply``: route, then
    dispatch every kept (token, k) pair into its expert's capacity buffer
    ``(E, G*C, D)``, run the grouped SwiGLU products
    (:func:`grouped_swiglu`), and combine each token's kept pairs by
    their router weights.

    Dispatch and combine go by index, one gather each way, where the
    reference multiplies by a ``(G, S*k, E, C)`` one-hot: in exact
    arithmetic both give each output as one product, and at
    DeepSeek-V2-Lite's widths the one-hot would cost ~4x the layer's
    expert work and 1.5 GB a layer kept for the backward pass.

    Expert-parallel along ``"model"`` (a sharded step whose gatherer hands
    out this rank's E/n experts, ``launch/sharding.model_computed``): the
    routing stays replicated (the router whole, global ids, capacity and
    queue ranks of all E experts), this rank keeps the pairs of its
    experts ``[r E/n, (r+1) E/n)`` in an ``(E/n, G*C, D)`` buffer (another
    rank's pair points at the zero row, as a dropped pair does), the
    normed input and the combine weights enter a ``"model"`` region and
    the partial combine, summed in float32, leaves it
    (``launch/shardctx``). The shared experts stay outside it.

    With ``resid`` (the stream the layer adds its output to, at the end
    of a layer group) the output is ``shardctx.constrain_act(resid +
    out)``: the region leaves onto this rank's sequence shard by a
    reduce-scatter where the activation spec shards the sequence
    (``shardctx.leave_model_act``), in place of its all-reduce.

    x (B, T, D) -> (out (B, T, D), aux loss, routed ids (B, T, k))."""
    m = cfg.moe
    b, t, d = x.shape
    n, k, e = b * t, m.top_k, m.num_experts
    w, idx, probs = route_train(p, cfg, x)
    aux = aux_load_balance_loss(cfg, probs, idx)
    sg = dispatch_group(cfg, n)
    g, c = n // sg, capacity(cfg, sg)
    ids = idx.reshape(n, k).long()
    rank = dispatch_rank(cfg, ids, sg)
    # this rank's experts: all E, or its E/n along "model"
    e_loc = p["w_gate"].shape[0]
    region = e_loc != e
    xr, wr = x, w
    if region:
        ids = ids - shardctx.model_shard()[0] * e_loc
        xr, wr = shardctx.enter_model(x), shardctx.enter_model(w)
    keep = (rank < c) & (ids >= 0) & (ids < e_loc)
    # buffer row of each pair, expert-major: (expert, group, rank); a
    # dropped pair, or another rank's, points one past the end, at a
    # zero row
    group = (torch.arange(n, device=x.device) // sg)[:, None]
    rows = e_loc * g * c
    slot = torch.where(keep, (ids * g + group) * c + rank, rows)
    token = torch.full((rows + 1,), n, dtype=torch.long, device=x.device)
    token.scatter_(0, slot.reshape(-1),
                   torch.arange(n * k, device=x.device) // k)
    xf = torch.cat([xr.reshape(n, d), xr.new_zeros(1, d)])
    x_e = xf[token[:rows]].reshape(e_loc, g * c, d)         # (E', G*C, D)
    y_e = grouped_swiglu(p, x_e).reshape(rows, d)
    y_e = torch.cat([y_e, y_e.new_zeros(1, d)])
    y = (y_e[slot.reshape(-1)].reshape(n, k, d)
         * wr.reshape(n, k, 1).to(x.dtype))
    if region:
        part = y.sum(1, dtype=torch.float32).reshape(b, t, d)
        if resid is not None:
            shared = (ffn_apply(p["shared"], x, "swiglu") if "shared" in p
                      else None)
            return shardctx.leave_model_act(part, resid, shared), aux, idx
        y = shardctx.leave_model(part).to(x.dtype)
    else:
        y = y.sum(1).reshape(b, t, d)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, "swiglu")
    if resid is not None:
        y = shardctx.constrain_act(resid + y)
    return y, aux, idx
