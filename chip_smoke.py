#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Usage, from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the five CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and identify the card;
2. hold each kernel against its plain PyTorch version at the main runs'
   full-width shapes (``paged_flash_decode`` in its MLA layout at decode
   and at a prefill chunk, and in its GQA layout; ``flash_decode`` on the
   8192-slot ring and a 128-slot row; ``expert_ffn`` at main run 1's
   decode and prefill-chunk shapes, main run 2's and the pipeline's
   batch-1 decode; ``ssd_chunk`` at both of main run 3's shapes, G 128
   and G 256, and the reduced mamba2 shape; ``topk_gating`` at main run
   1's decode and prefill-chunk shapes, main run 2's, the pipeline's and
   the training forward's (4,096 rows x 64 experts top-6, 2,048 x 16
   top-2); and the three serving kernels at serve_trained's float32
   shapes on the 53.5 M backbone), on rows with a tie across the k-th
   place, all values
   equal, and probabilities underflowed to 0; for all five, two calls on
   the same inputs must be bit-identical), in bfloat16 and float32 (the
   router in float32 only), and time kernel, plain version and a PyTorch
   library yardstick with CUDA events: ``ms`` is device time (calls
   replayed from a CUDA graph), ``eager_ms`` the time per eager call,
   Python and launch overhead included; ``launch_floor_ms`` is one trivial
   launch timed the same way, first, and ``topk_gating``'s
   ``floor_ratio`` is its ms over that floor;
3. main run: full-width DeepSeek-V2-Lite in bfloat16 (seeded random
   weights, routed experts in pinned host memory, 28.8 GB) served by
   ``BatchedOffloadEngine`` with the paper's learned prefetch policy at a
   10% expert cache, counting every kernel launch; its modeled fetches
   (and main run 2's) priced at this card's host-to-device rate, measured
   once before the phases (``measured_host_bw``, one expert's pinned
   copies);
4. on-card parity: DeepSeek-V2-Lite at full width, float32, depth cut to 3
   layers; the engine on the card and on the CPU from identical weights
   must give identical streams, routed expert ids and counters;
4a. pipeline: the paper's pipeline on main run 1's backbone (full width
   and depth, bfloat16, the same seed), every routed expert on the device
   (~31 GB): 32 batch-1 traces of 64 prompt tokens from the topic corpus
   and 16 sampled ones (2,560 decode steps through the facade's decode
   mode, ``topk_gating`` and ``expert_ffn`` on every MoE layer), the
   paper's full-size predictor trained on 24 of them with
   ``train_predictor``'s defaults, and the other 8 replayed through the
   cache simulator at a 10% cache with all seven policies, each with its
   per-trace standard error; fails unless both kernels launched exactly
   once per MoE layer and step (26 x 2,560), every loss is finite, the
   trained predictor's validation loss is below the untrained one's and
   the oracle hits every access; it hands the trained predictor on;
4a'. main run trained: main run 1 again with that trained predictor in
   ``OnlineMoEBeyondPolicy``; fails unless its streams, routed ids and
   launches equal main run 1's;
4b. parity pipeline: the same in float32 on the reduced DeepSeek-V2-Lite:
   greedy traces on the card and on the CPU identical, the predictor's
   logits within 1e-4, the simulator's table of every policy identical;
4c. train: DeepSeek-V2-Lite at full width in bfloat16, depth cut to 4
   layers (1 dense, 3 MoE; 2.25 B parameters), 8 AdamW steps at B 4 x S
   1024 on the topic corpus (one dispatch group a step, the chunked loss);
   fails unless every loss is finite, the last below the first, and
   ``topk_gating`` launched exactly 3 x 8 times;
4d. parity train: the reduced DeepSeek-V2-Lite in float32, one ``loss_fn``
   with its gradients and 3 quickstart AdamW steps on the card and on the
   CPU, each step from the same weights and moments: routed ids
   identical, loss, gradients and step losses within tolerance, a step
   routed apart only at a near-tie;
4e. pipeline trained: the ~100M config of ``examples/train_backbone.py``
   trained 200 steps at B 8 x S 256, then 4a's steps 2-4 on it at 10% and
   20% caches, beside 4a's random-backbone table;
4f. serve trained: that backbone serves the 8 held-out prompts greedily
   (16 new tokens, a 50 us layer clock, the host rate 4e measured): the
   batch-1 ``OffloadEngine`` at 10% and 20% caches with every policy of
   ``launch.serve.build_policy`` at width top-k and the untrained
   predictor as a control, then ``BatchedOffloadEngine`` at 10% with no
   prefetch and with the trained predictor; each row beside the
   simulator's hit rate for the same policy and cache, and whether the
   two rank the policies alike (reported); fails unless, within each
   engine, streams and routed ids do not depend on the policy, each
   kernel launched exactly once per (MoE) layer of each step and prefill
   chunk (``paged_flash_decode`` only in the batched engine), and hits +
   misses equal the routed accesses;
5. main run 2: full-width Llama-4-Scout in bfloat16, depth cut to 8 layers
   (two 3:1 chunked:global groups; 32.2 GB of routed experts in pinned
   host memory), paged engine: global layers through the block pools
   (``paged_flash_decode``, GQA layout), chunked layers through contiguous
   rows (``flash_decode``), prompts streamed token by token;
6. parity run 2: Llama-4-Scout at full width, float32, one chunked and one
   global layer with a 16-slot chunk; the paged, the ``paged=False`` and
   the batch-1 engine each identical on the card and on the CPU, and the
   three identical to each other;
7. main run 3: mamba2-130m at full width and depth (24 SSD layers) in
   bfloat16 through the model facade: ``prefill`` of 4 prompts of 4,000
   tokens and 64 greedy ``decode_step``s, then one 32,768-token prompt and
   16 steps; every prefill layer's within-chunk term goes through
   ``ssd_chunk``;
8. parity run 3: mamba2-130m at full width in float32, depth cut to 4
   layers: 2 prompts of 300 tokens and 16 greedy steps through the facade
   on the card and on the CPU from identical weights; identical streams
   and last-position logits within 1e-3. TF32 is off for the whole
   script (matmul and cuDNN), and the causal convolution is a
   shift-and-add, never a cuDNN convolution.

Phases 4a-4f are named ``pipeline``, ``main_run_trained``,
``parity_pipeline``, ``train``, ``parity_train``, ``pipeline_trained`` and
``serve_trained`` in the output. Host memory: about 32 GB for main run 2's pinned experts (each
main run's pinned blocks are released before the next phase), and 16 GB
of float32 experts for parity run 2. The last stdout line is ``{"ok": true,
"device": {...}}``; the line before it is the card's name and power limit;
before that the ``{"kernels": [...]}`` line, whose ``launches`` are the
counts of the main run that drives each kernel (Llama-4-Scout's for the
four attention and MoE kernels, mamba2's for ``ssd_chunk``;
``launches_by_run`` has every main run's and the pipeline,
main_run_trained, train, pipeline_trained and serve_trained phases'), and
before that ``{"launch_floor_ms": ...}`` and the phases' summaries. Details go to
``chiprun_out/chip_smoke.json``.
This script imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

HBM_BYTES_S = 3.35e12          # H100 SXM memory rate
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph and
    replayed, timed with CUDA events, so the Python and launch overhead of
    each eager call is left out (``cuda_ms`` keeps it in)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def timings(torch, kernel, plain, library=None) -> dict:
    """Device and eager per-call times of a kernel, its plain version and
    the library yardstick (None when there is none)."""
    lib = library is not None
    return {"ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain),
            "library_ms": device_ms(torch, library) if lib else None,
            "eager_ms": cuda_ms(torch, kernel),
            "plain_eager_ms": cuda_ms(torch, plain),
            "library_eager_ms": cuda_ms(torch, library) if lib else None}


def bound(nbytes: float, ops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of the data's type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at main-path shapes

# paged_flash_decode's shapes on the main path, block size 8: main run 1's
# (cache_len 128, W 16; ``qk`` the query-key width the scores are scaled
# by) MLA shared page at decode and at a prefill chunk (8 tokens of one
# request as 8 lanes sharing its table), GQA layout at decode (main run 2's
# global layers), and serve_trained's batched runs on the trained 53.5 M
# backbone in float32 (cache_len 81, W 11): 8 heads over its 64 + 16 latent
# at decode and at a prefill chunk, 5 tokens (the 11-slot cache clamps the
# chunk to 11 // top-2 pairs)
PAGED_SHAPES = {
    "mla": dict(kvh=1, g=16, dk=576, dv=512, gqa=False, qk=192),
    "gqa": dict(kvh=8, g=5, dk=128, dv=128, gqa=True, qk=128),
    "prefill": dict(kvh=1, g=16, dk=576, dv=512, gqa=False, qk=192,
                    pos_list=tuple(range(56, 64)), shared_table=True),
    "serve_decode": dict(kvh=1, g=8, dk=80, dv=64, gqa=False, qk=48,
                         pos_list=(79, 75, 71, 67), w=11, timed="float32"),
    "serve_prefill": dict(kvh=1, g=8, dk=80, dv=64, gqa=False, qk=48,
                          pos_list=tuple(range(55, 60)), shared_table=True,
                          w=11, timed="float32"),
}


def check_paged(torch, F, dev, gen):
    """``paged_flash_decode`` at every shape of ``PAGED_SHAPES``, the first
    at the top level."""
    from repro_torch.kernels import paged_attention as pa
    out = paged_case(torch, F, dev, gen, pa, **PAGED_SHAPES["mla"])
    for name in list(PAGED_SHAPES)[1:]:
        out[name] = paged_case(torch, F, dev, gen, pa, **PAGED_SHAPES[name])
    return out


def paged_inputs(torch, dev, gen, dt, kvh, g, dk, dv, gqa, qk,
                 pos_list=(95, 90, 84, 71), shared_table=False, w=16):
    """(args, keywords) of one call: decode lanes (prompt + decode
    positions) with a table of ``w`` blocks each, or the tokens of one
    prefill chunk as lanes sharing one table; seeded random q and pools in
    type ``dt``."""
    n, bs = len(pos_list), 8
    q = torch.randn(n, kvh, g, dk, generator=gen, device=dev).to(dt)
    pool = torch.randn(n * w + 1, bs, kvh, dk, generator=gen,
                       device=dev).to(dt)
    v_pool = (torch.randn(n * w + 1, bs, kvh, dv, generator=gen,
                          device=dev).to(dt) if gqa else None)
    tables = (1 + torch.randperm(n * w, generator=gen, device=dev)
              ).to(torch.int32).reshape(n, w)
    if shared_table:
        tables = tables[:1].expand(n, w).contiguous()
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    return (q, pool, v_pool, tables, pos), {"scale": qk ** -0.5, "dv": dv}


def paged_case(torch, F, dev, gen, pa, kvh, g, dk, dv, gqa, qk,
               pos_list=(95, 90, 84, 71), shared_table=False, w=16,
               timed="bfloat16"):
    """One shape in f32 and bf16 against the plain version; two calls on
    the same inputs must be bit-identical; timed in the ``timed`` dtype
    (the one its run calls it in)."""
    n, bs = len(pos_list), 8
    pos_list = list(pos_list)
    label = (f"paged_flash_decode ({'GQA' if gqa else 'MLA'} layout, "
             f"{n} lanes)")
    out = {}
    for dtype in ("float32", "bfloat16"):
        args, kw = paged_inputs(torch, dev, gen, getattr(torch, dtype), kvh,
                                g, dk, dv, gqa, qk, pos_list, shared_table, w)
        q, pool, v_pool, tables, pos = args
        scale = kw["scale"]
        o = pa.paged_flash_decode(*args, **kw)
        o2 = pa.paged_flash_decode(*args, **kw)
        op = pa.paged_flash_decode_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(o, o2):
            fail(f"{label} {dtype}: two calls on the same inputs differ")
        err = (o.float() - op.float()).abs().max().item()
        tol = 1e-4 if dtype == "float32" else 3e-2
        if not err <= tol:
            fail(f"{label} {dtype}: max abs err {err} > {tol}")
        out[dtype] = err
        if dtype != timed:
            continue
        kpos = torch.arange(w * bs, device=dev)
        mask = (kpos[None, :] <= pos[:, None].long())[:, None, None, :]
        h = kvh * g

        def library():   # gather the pages, then one dense attention call
            if not gqa:  # one latent page per position: K and V are views
                k = pool[tables.reshape(-1).long()].reshape(n, 1, w * bs, dk)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2).reshape(n, g, 1, dk),
                    k.expand(n, g, w * bs, dk),
                    k[..., :dv].expand(n, g, w * bs, dv), attn_mask=mask,
                    scale=scale)
            flat = tables.reshape(-1).long()
            k = pool[flat].reshape(n, w * bs, kvh, 1, dk)
            v = v_pool[flat].reshape(n, w * bs, kvh, 1, dv)
            k = k.expand(n, w * bs, kvh, g, dk).reshape(n, w * bs, h, dk)
            v = v.expand(n, w * bs, kvh, g, dv).reshape(n, w * bs, h, dv)
            return F.scaled_dot_product_attention(
                q.reshape(n, h, 1, dk), k.transpose(1, 2),
                v.transpose(1, 2), attn_mask=mask, scale=scale)
        out.update(timings(
            torch, lambda: pa.paged_flash_decode(*args, **kw),
            lambda: pa.paged_flash_decode_plain(*args, **kw), library))
        keys = sum(p + 1 for p in pos_list)
        rows = tables.tolist()      # distinct live pages, each read once
        pages = len({rows[i][j] for i, p in enumerate(pos_list)
                     for j in range(p // bs + 1)})
        el = q.element_size()
        page_bytes = bs * kvh * (dk + (dv if gqa else 0)) * el
        nbytes = (pages * page_bytes + q.numel() * el + n * h * dv * el
                  + tables.numel() * 4 + n * 4)
        ops = keys * h * (2 * dk + 2 * dv)
        b_ms, b_by = bound(nbytes, ops, dtype)
        pools = (f"K/V pools ({n * w + 1},{bs},{kvh},{dk}) each" if gqa
                 else f"pool ({n * w + 1},{bs},1,{dk}), dv {dv}")
        tabs = "one table shared by the lanes" if shared_table else "tables"
        short = "bf16" if dtype == "bfloat16" else "f32"
        out.update(bound_ms=b_ms, bound_by=b_by, bit_identical=True,
                   shape=f"q ({n},{kvh},{g},{dk}) {short}, {pools}, {tabs} "
                         f"({n},{w}), pos {pos_list}")
    return out


# flash_decode's shapes on main run 2 (Llama-4-Scout's chunked layers): 4
# lanes of 40 query heads over 8 kv heads, hd 128, valid_len up to 96 of
# a row of the chunked ring (S = 8192, the timed case) or of a global row
# (S = cache_len = 128)
FLASH_SHAPES = {"ring": dict(s_len=8192), "global": dict(s_len=128)}


def flash_inputs(torch, dev, gen, dt, s_len, vl_list=(96, 90, 84, 71)):
    """(q, k_cache, v_cache, rows, valid_len) of one call: 5 cache rows,
    lanes on rows 3, 0, 2, 1; seeded random q and caches in type ``dt``."""
    n, h, kvh, hd, r = 4, 40, 8, 128, 5
    q = torch.randn(n, h, hd, generator=gen, device=dev).to(dt)
    kc = torch.randn(r, s_len, kvh, hd, generator=gen, device=dev).to(dt)
    vc = torch.randn(r, s_len, kvh, hd, generator=gen, device=dev).to(dt)
    rows = torch.tensor([3, 0, 2, 1], dtype=torch.int32, device=dev)
    vl = torch.tensor(vl_list, dtype=torch.int32, device=dev)
    return q, kc, vc, rows, vl


def check_flash(torch, F, dev, gen):
    """``flash_decode`` at every shape of ``FLASH_SHAPES`` in f32 and bf16
    against its plain version; two calls on the same inputs must be
    bit-identical; bf16 at S = 8192 timed."""
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for s_len in (FLASH_SHAPES["global"]["s_len"],
                  FLASH_SHAPES["ring"]["s_len"]):
        for dtype in ("float32", "bfloat16"):
            args = flash_inputs(torch, dev, gen, getattr(torch, dtype), s_len)
            q, kc, vc, rows, vl = args
            n, h, hd = q.shape
            kvh = kc.shape[2]
            o = fa.flash_decode(*args)
            o2 = fa.flash_decode(*args)
            op = fa.flash_decode_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(o, o2):
                fail(f"flash_decode S={s_len} {dtype}: two calls on the same "
                     "inputs differ")
            err = (o.float() - op.float()).abs().max().item()
            tol = 1e-4 if dtype == "float32" else 3e-2
            if not err <= tol:
                fail(f"flash_decode S={s_len} {dtype}: max abs err {err} "
                     f"> {tol}")
            out[dtype if s_len == 8192 else f"{dtype}_S{s_len}"] = err
            if dtype != "bfloat16" or s_len != 8192:
                continue
            vl_list = vl.tolist()
            vmax = max(vl_list)
            mask = (torch.arange(vmax, device=dev)[None, :]
                    < vl[:, None].long())[:, None, None, :]
            g = h // kvh

            def library():  # rows sliced to the longest valid_len, one SDPA
                idx = rows.long()
                k = kc[idx, :vmax][:, :, :, None].expand(
                    n, vmax, kvh, g, hd).reshape(n, vmax, h, hd)
                v = vc[idx, :vmax][:, :, :, None].expand(
                    n, vmax, kvh, g, hd).reshape(n, vmax, h, hd)
                return F.scaled_dot_product_attention(
                    q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask)
            out.update(timings(torch, lambda: fa.flash_decode(*args),
                               lambda: fa.flash_decode_plain(*args),
                               library))
            keys = sum(vl_list)
            el = 2
            nbytes = (keys * kvh * hd * 2 * el + 2 * q.numel() * el
                      + 2 * n * 4)
            ops = keys * h * 4 * hd
            out["bound_ms"], out["bound_by"] = bound(nbytes, ops,
                                                     "bfloat16")
            out["bit_identical"] = True
            out["shape"] = (f"q ({n},{h},{hd}) bf16, K/V rows "
                            f"({kc.shape[0]},{s_len},{kvh},{hd}) each, rows "
                            f"{rows.tolist()}, valid_len {vl_list}")
    return out


# expert_ffn's shapes on the main path: main run 1's decode (DeepSeek-V2-Lite:
# 4 lanes, top-6, D 2048, F 1408, 166 slots) and prefill chunk (8 tokens
# whose 48 pairs name PREFILL_DISTINCT_SLOTS distinct slots: the mean per
# call, 18.7, that main run 1 showed on an H100, which main_run reports as
# `distinct_slots_per_expert_call`), main run 2's (Llama-4-Scout: top-1,
# D 5120, F 8192, 12 slots), the pipeline's batch-1 trace decode (one
# token, top-6, the layer's 64 experts as the slot buffer), and
# serve_trained's engines on the float32 53.5 M backbone at the 10% cache
# (11 slots): one token (batch 1), 4 decode lanes and a 5-token prefill
# chunk (batched)
PREFILL_DISTINCT_SLOTS = 19
EXPERT_SHAPES = {
    "deepseek": dict(n=4, k=6, d=2048, f=1408, slots=166),
    "llama4": dict(n=4, k=1, d=5120, f=8192, slots=12),
    "prefill": dict(n=8, k=6, d=2048, f=1408, slots=166,
                    distinct=PREFILL_DISTINCT_SLOTS),
    "pipeline": dict(n=1, k=6, d=2048, f=1408, slots=64),
    # pipeline_trained's trace decode: the float32 ~100M-family backbone's
    # 1 token, top-2 of its 16 experts
    "pipeline_trained": dict(n=1, k=2, d=256, f=512, slots=16,
                             timed="float32"),
    "serve_b1": dict(n=1, k=2, d=256, f=512, slots=11, timed="float32"),
    "serve_decode": dict(n=4, k=2, d=256, f=512, slots=11, timed="float32"),
    "serve_prefill": dict(n=5, k=2, d=256, f=512, slots=11, timed="float32"),
}


def check_expert(torch, dev, gen):
    """``expert_ffn`` at every shape of ``EXPERT_SHAPES``, the first at the
    top level."""
    out = expert_case(torch, dev, gen, **EXPERT_SHAPES["deepseek"])
    for name in list(EXPERT_SHAPES)[1:]:
        out[name] = expert_case(torch, dev, gen, **EXPERT_SHAPES[name])
    return out


def expert_inputs(torch, dev, gen, dt, n, k, d, f, slots, distinct=None):
    """(x, weights, slot_idx, wg, wu, wd) of one call: seeded random slot
    buffers, x and weights in type ``dt``; the n*k pairs name ``distinct``
    slots (all different when None), each used in turn, so a row's k slots
    are distinct as top-k makes them and the first pairs' slots recur."""
    bufs = [(torch.randn(slots, *shape, generator=gen, device=dev)
             * 0.02).to(dt) for shape in ((d, f), (d, f), (f, d))]
    x = torch.randn(n, d, generator=gen, device=dev).to(dt)
    w = torch.rand(n, k, generator=gen, device=dev).to(dt)
    distinct = n * k if distinct is None else distinct
    pool = torch.randperm(slots, generator=gen, device=dev)[:distinct]
    sl = pool[torch.arange(n * k, device=dev) % distinct].to(
        torch.int32).reshape(n, k)
    return x, w, sl, *bufs


def expert_case(torch, dev, gen, n, k, d, f, slots, distinct=None,
                timed="bfloat16"):
    """One shape in f32 and bf16 against the plain version; two calls on
    the same inputs must be bit-identical; timed in the ``timed`` dtype
    (the one its run calls it in)."""
    from repro_torch.kernels import expert_ffn as ef
    out = {}
    for dtype in ("float32", "bfloat16"):
        args = expert_inputs(torch, dev, gen, getattr(torch, dtype), n, k, d,
                             f, slots, distinct)
        sl = args[2]
        y = ef.expert_ffn(*args)
        y2 = ef.expert_ffn(*args)
        yp = ef.expert_ffn_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(y, y2):
            fail(f"expert_ffn ({n},{k},{d},{f}) {dtype}: two calls on the "
                 "same inputs differ")
        err = (y.float() - yp.float()).abs().max().item()
        scale = max(1.0, yp.float().abs().max().item())
        tol = (1e-4 if dtype == "float32" else 2e-2) * scale
        if not err <= tol:
            fail(f"expert_ffn ({n},{k},{d},{f}) {dtype}: max abs err {err} "
                 f"> {tol}")
        out[dtype] = err
        if dtype == timed:
            out.update(timings(torch, lambda: ef.expert_ffn(*args),
                               lambda: ef.expert_ffn_plain(*args)))
            n_distinct = len(set(sl.reshape(-1).tolist()))
            size = args[0].element_size()
            nbytes = (n_distinct * 3 * d * f * size + 2 * n * d * size
                      + n * k * 6)
            ops = n * k * 6 * d * f
            out["bound_ms"], out["bound_by"] = bound(nbytes, ops, dtype)
            out["bit_identical"] = True
            short = "bf16" if dtype == "bfloat16" else "f32"
            out["shape"] = (f"x ({n},{d}) {short}, k {k}, slot buffers "
                            f"({slots},{d},{f})/({slots},{f},{d}), "
                            f"{n_distinct} distinct slots")
        del args
    return out


# topk_gating's shapes on the main path: main run 1's router at decode (4
# lanes) and at a prefill chunk (8 tokens of one request), 64 experts top-6,
# main run 2's (16 experts, top-1), the pipeline's batch-1 trace decode, and
# the training forward's ids: the train phase's B 4 x S 1024 tokens (64
# experts, top-6) and pipeline_trained's B 8 x S 256 (16 experts, top-2),
# then serve_trained's batched decode (4 lanes) and prefill chunk (5
# tokens) on the 53.5 M backbone (its batch-1 row is pipeline_trained's)
TOPK_SHAPES = {
    "deepseek": dict(t=4, e=64, k=6),
    "prefill": dict(t=8, e=64, k=6),
    "llama4": dict(t=4, e=16, k=1),
    "pipeline": dict(t=1, e=64, k=6),
    "train": dict(t=4096, e=64, k=6),
    "train_100m": dict(t=2048, e=16, k=2),
    "pipeline_trained": dict(t=1, e=16, k=2),
    "serve_decode": dict(t=4, e=16, k=2),
    "serve_prefill": dict(t=5, e=16, k=2),
}


def check_topk(torch, dev, gen, floor_ms):
    """``topk_gating`` at every shape of ``TOPK_SHAPES``, the first at the
    top level; ``floor_ms`` is this run's ``launch_floor_ms``."""
    out = topk_case(torch, dev, gen, floor_ms, **TOPK_SHAPES["deepseek"])
    for name in list(TOPK_SHAPES)[1:]:
        out[name] = topk_case(torch, dev, gen, floor_ms, **TOPK_SHAPES[name])
    return out


def topk_edge_rows(logits, k):
    """Make rows 0-3 of ``logits`` (T, E), those that exist, the cases a
    selection rule can get wrong, in place: 0, a tie across the k-th place
    (the values at ranks k-1, k and k+1 made equal; k-2 and k-1 when
    k == E); 1, all equal; 2, all but its max(1, k // 2) largest lowered
    by 300, so that their probabilities underflow to exactly 0 and are
    taken in id order; 3, an exact tie at the top between experts 0 and
    E-1. Returns ``logits``."""
    t, e = logits.shape
    if e < 2:
        return logits
    if t > 0:
        order = logits[0].argsort(descending=True, stable=True)
        lo = min(k - 1, e - 2)
        logits[0, order[lo:lo + 3]] = logits[0, order[lo]].item()
    if t > 1:
        logits[1] = 0.5
    if t > 2:
        order = logits[2].argsort(descending=True, stable=True)
        logits[2, order[max(1, k // 2):]] -= 300.0
    if t > 3:
        logits[3, 0] = logits[3, e - 1] = logits[3].max() + 1.0
    return logits


def topk_inputs(torch, dev, gen, t, e, k):
    """Seeded router logits (T, E) f32 with ``topk_edge_rows``."""
    return topk_edge_rows(torch.randn(t, e, generator=gen, device=dev) * 2, k)


def topk_case(torch, dev, gen, floor_ms, t, e, k):
    """One shape against the plain version (ids equal, weights within
    1e-6); two calls on the same inputs must be bit-identical; timed, with
    ``floor_ratio`` = ms / ``floor_ms`` and ``digest``, a hash of the
    kernel's (w, idx), so that two versions can be shown to agree."""
    from repro_torch.kernels import topk_gating as tg
    logits = topk_inputs(torch, dev, gen, t, e, k)
    w, idx = tg.topk_gating(logits, k)
    w2, idx2 = tg.topk_gating(logits, k)
    wp, ip = tg.topk_gating_plain(logits, k)
    torch.cuda.synchronize()
    if not (torch.equal(w, w2) and torch.equal(idx, idx2)):
        fail(f"topk_gating ({t},{e},{k}): two calls on the same inputs "
             "differ")
    if not torch.equal(idx, ip):
        fail(f"topk_gating ({t},{e},{k}) ids differ from the plain "
             f"version:\n{idx}\n{ip}")
    err = (w - wp).abs().max().item()
    if not err <= 1e-6:
        fail(f"topk_gating ({t},{e},{k}) weights: max abs err {err} > 1e-6")
    digest = hashlib.sha256(w.cpu().numpy().tobytes()
                            + idx.cpu().numpy().tobytes()).hexdigest()[:16]

    def library():
        pw, pi = torch.topk(torch.softmax(logits, -1), k)
        return pw / (pw.sum(-1, keepdim=True) + 1e-9), pi
    times = timings(torch, lambda: tg.topk_gating(logits, k),
                    lambda: tg.topk_gating_plain(logits, k), library)
    b_ms, b_by = bound(t * e * 4 + t * k * 8, t * e * (4 + k), "float32")
    return {"float32": err, "bound_ms": b_ms, "bound_by": b_by,
            "floor_ratio": times["ms"] / floor_ms, "digest": digest,
            "bit_identical": True, "shape": f"logits ({t},{e}) f32, k {k}",
            **times}


def ssd_shapes() -> dict:
    """(G, H, L, N, P) of every ``ssd_chunk`` call main run 3 makes, by
    part of ``MAMBA_PARTS`` (G = requests x chunks per prompt: 4 x 32 and
    1 x 256), then the reduced config's (L 32, N 32, 8 heads)."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssd import ssd_dims
    cfg = get_config(MAMBA2)
    heads = ssd_dims(cfg)[1]
    l, n, p = cfg.ssm.chunk, cfg.ssm.d_state, cfg.ssm.headdim
    shapes = {name: (batch * -(-prompt_len // l), heads, l, n, p)
              for name, batch, prompt_len, _ in MAMBA_PARTS}
    shapes["reduced"] = (2 * 8, 8, 32, 32, 64)
    return shapes


def check_ssd(torch, dev, gen):
    """``ssd_chunk`` at every shape of ``ssd_shapes``, the first part's
    case at the top level; main run 3's shapes timed in float32, as the
    model path calls them."""
    out = {}
    for i, (name, shape) in enumerate(ssd_shapes().items()):
        case = ssd_case(torch, dev, gen, *shape, timed=name != "reduced")
        if i == 0:
            out.update(case)
        else:
            out[name] = case
    return out


def ssd_inputs(torch, dev, gen, dt, g, h, l, n, p):
    """(c, b, xdt, a_cum) of one call: seeded random, a_cum a decreasing
    float32 cumulative sum."""
    c = (torch.randn(g, l, n, generator=gen, device=dev) * 0.3).to(dt)
    b = (torch.randn(g, l, n, generator=gen, device=dev) * 0.3).to(dt)
    x = (torch.randn(g, h, l, p, generator=gen, device=dev) * 0.5).to(dt)
    a = -(torch.rand(g, h, l, generator=gen, device=dev) * 0.2).cumsum(-1)
    return c, b, x, a


def ssd_case(torch, dev, gen, g, h, l, n, p, timed=False):
    """One shape in f32 and bf16 against the plain version; two calls on
    the same inputs must be bit-identical; f32 timed when ``timed``."""
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.runtime import device_sm_count
    plan = getattr(sc, "cta_heads", None)   # absent in older checkouts
    out = {"G": g, "heads_per_cta": plan(g, h, device_sm_count(dev.index))
           if plan else None}
    for dtype in ("float32", "bfloat16"):
        c, b, x, a = ssd_inputs(torch, dev, gen, getattr(torch, dtype), g, h,
                                l, n, p)
        y = sc.ssd_chunk(c, b, x, a)
        y2 = sc.ssd_chunk(c, b, x, a)
        yp = sc.ssd_chunk_plain(c, b, x, a)
        torch.cuda.synchronize()
        if not torch.equal(y, y2):
            fail(f"ssd_chunk ({g},{h},{l},{n},{p}) {dtype}: two calls on the "
                 "same inputs differ")
        err = (y.float() - yp.float()).abs().max().item()
        scale = max(1.0, yp.float().abs().max().item())
        tol = (1e-4 if dtype == "float32" else 1e-2) * scale
        if not err <= tol:
            fail(f"ssd_chunk ({g},{h},{l},{n},{p}) {dtype}: max abs err {err} "
                 f"> {tol}")
        out[dtype] = err
        out[f"{dtype}_out_abs_max"] = scale
        out["bit_identical"] = True
        if dtype != "float32" or not timed:
            continue
        mask = torch.ones(l, l, dtype=torch.bool, device=dev).tril()

        def library():   # two matmuls around the masked decay (TF32 off)
            s = torch.matmul(c, b.transpose(1, 2))
            seg = (a[..., :, None] - a[..., None, :]).masked_fill(
                ~mask, float("-inf"))
            return torch.matmul(s[:, None] * torch.exp(seg), x)
        out.update(timings(torch, lambda: sc.ssd_chunk(c, b, x, a),
                           lambda: sc.ssd_chunk_plain(c, b, x, a), library))
        # the work the function needs: C B^T once per chunk (C and B are
        # shared across heads) and the masked products over the lower
        # triangle, 2 operations per multiply-add; the TPU kernel's grid
        # did G*H*2*L*L*(N+P), kept beside it
        ops = g * l * (l + 1) * (n + h * p)
        nbytes = 2 * g * l * n * 4 + 2 * g * h * l * p * 4 + g * h * l * 4
        out["bound_ms"], out["bound_by"] = bound(nbytes, ops, "float32")
        out["bound_ms_tpu_work"] = bound(
            nbytes, g * h * 2 * l * l * (n + p), "float32")[0]
        out["shape"] = (f"c, b ({g},{l},{n}), xdt ({g},{h},{l},{p}), a_cum "
                        f"({g},{h},{l}) f32")
    return out


def launch_floor_ms(torch, dev) -> float:
    """Device time of one trivial launch (an in-place add on a one-element
    tensor), replayed from a CUDA graph as ``device_ms`` times kernels: the
    least a kernel of the port can take."""
    x = torch.zeros(1, device=dev)
    return device_ms(torch, lambda: x.add_(1.0))


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine

def record_routes(core, check_finite: bool = False, kinds=None):
    """Wrap a DecodeCore so each step/chunk logs its routed expert ids: a
    step's per request and MoE layer, a chunk's per MoE layer and token.
    With ``kinds`` (a list), each entry's kind is appended to it too."""
    import numpy as np
    log_ = []
    step, chunk = core.step, core.prefill_chunk

    def rec_step(*a, **kw):
        out = step(*a, **kw)
        if check_finite and not np.isfinite(out[0]).all():
            fail("non-finite logits in a decode step")
        log_.append([[sorted(int(e) for e in g) for g in r] for r in out[2]])
        if kinds is not None:
            kinds.append("decode")
        return out

    def rec_chunk(*a, **kw):
        out = chunk(*a, **kw)
        if check_finite and not np.isfinite(out[0]).all():
            fail("non-finite logits in a prefill chunk")
        log_.append([[sorted(int(e) for e in g) for g in r] for r in out[2]])
        if kinds is not None:
            kinds.append("prefill_chunk")
        return out

    core.step, core.prefill_chunk = rec_step, rec_chunk
    return log_


def distinct_slots(routes, kinds) -> dict:
    """Mean distinct experts (so distinct slots) per ``expert_ffn`` call, by
    call kind, from ``record_routes``'s log: one call per MoE layer of a
    decode step (the union over its lanes) or of a prefill chunk (over its
    tokens). Pad lanes are not logged; they name slot 0."""
    per = {}
    for entry, kind in zip(routes, kinds):
        layers = (zip(*entry) if kind == "decode" else entry)
        for sets in layers:
            per.setdefault(kind, []).append(len(set().union(*map(set, sets))))
    return {kind: sum(v) / len(v) for kind, v in per.items()}


def predictor_config(PredictorConfig, cfg):
    """The paper's full-size predictor over this backbone's MoE layers."""
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    return PredictorConfig(token_emb_dim=cfg.d_model, num_model_layers=n_moe,
                           num_experts=cfg.moe.num_experts,
                           top_k=cfg.moe.top_k)


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


# main runs: (arch, depth to cut to or None, prompt length, the kernels
# the run must launch); each is served at full width in bfloat16
MAIN_RUNS = {
    "deepseek-v2-lite": (None, 64, ("paged_flash_decode", "expert_ffn",
                                    "topk_gating")),
    "llama4-scout-17b-a16e": (8, 32, ("paged_flash_decode", "flash_decode",
                                      "expert_ffn", "topk_gating")),
}


def release_host_memory(torch) -> None:
    """Free the previous phase's tensors, including the pinned host blocks
    PyTorch's host allocator keeps cached after they are freed."""
    gc.collect()
    torch.cuda.empty_cache()
    empty = (getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                     None) or getattr(torch._C, "_host_emptyCache", None))
    if empty is not None:
        empty()


def digest(obj) -> str:
    """A short hash of a JSON-able value (streams, routed ids)."""
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


def main_run(torch, np, dev, arch, host_bw, predictor=None):
    """One main run: ``arch`` at full width in bfloat16 through
    ``BatchedOffloadEngine`` with ``OnlineMoEBeyondPolicy``, holding a
    full-size predictor drawn from a seed, or ``predictor`` = (params,
    config) when given. Returns (result, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.core.predictor import predictor_init
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    depth, prompt_len, need = MAIN_RUNS[arch]
    cfg = get_config(arch)
    full_depth = cfg.num_layers
    m = cfg.moe
    per_layer = m.num_experts * 3 * cfg.d_model * m.d_ff_expert * 2
    avail = host_available_bytes()
    n_layers = min(cfg.num_layers, depth or cfg.num_layers)
    # routed experts live in pinned host memory: cut depth (never widths)
    # further only if they would not fit beside a 16 GB margin, keeping
    # one whole block pattern so every layer kind runs
    fit = int((avail - 16e9) // per_layer) + m.first_dense_layers
    if fit < n_layers:
        n_layers = max(m.first_dense_layers + max(2, len(cfg.block_pattern)),
                       fit)
        log(f"{arch}: depth cut to {n_layers} layers: {avail / 1e9:.1f} GB "
            "host memory available")
    cfg = cfg.replace(num_layers=n_layers)
    n_moe = n_layers - m.first_dense_layers
    capacity = max(int(0.10 * n_moe * m.num_experts), 4 * m.top_k)
    torch.cuda.reset_peak_memory_stats()     # the peak of this run's model
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED)
    model = build_model(cfg)
    params = model.init(gen, device=dev, expert_device="cpu")
    if predictor is None:
        pc = predictor_config(PredictorConfig, cfg)
        pp = predictor_init(torch.Generator(dev).manual_seed(SEED + 1), pc,
                            device=dev)
    else:
        pp, pc = predictor
    eng = BatchedOffloadEngine(
        model, params, lambda: OnlineMoEBeyondPolicy(pp, pc), capacity,
        host_bw=host_bw, max_batch=4, block_size=8, prefill_chunk=8,
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
               for _ in range(4)]
    max_new, cache_len = 32, 128
    kinds = []
    routes = record_routes(eng.core, check_finite=True, kinds=kinds)
    reset_launch_counts()
    t1 = time.perf_counter()
    outs = eng.generate(prompts, max_new, cache_len)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = launch_counts()
    for name in need:
        if launches[name] == 0:
            fail(f"{arch} main run never launched the {name} kernel")
    for s in outs:
        if len(s) != max_new + 1 or not all(0 <= x < cfg.vocab_size
                                            for x in s):
            fail(f"bad stream from the {arch} main run: {s}")
    st = eng.stats
    generated = sum(len(s) for s in outs)
    result = {
        "config": cfg.name, "dtype": cfg.dtype, "layers": n_layers,
        "full_depth": full_depth, "depth_cut": n_layers != full_depth,
        "kinds": list(cfg.layer_kinds()), "requests": len(prompts),
        "prompt_len": prompt_len, "max_new": max_new,
        "cache_len": cache_len, "max_batch": 4, "block_size": 8,
        "prefill_chunk": 8, "capacity_slots": capacity,
        "routed_experts": n_moe * m.num_experts,
        "pinned_expert_bytes": n_moe * per_layer,
        "host_available_bytes_before": avail,
        "policy": "moe-beyond-online",
        "predictor": "seeded" if predictor is None else "trained",
        "predictor_max_seq": pc.max_seq, "init_s": init_s, "run_s": run_s,
        "generated_tokens": generated,
        "generated_tokens_per_s": generated / run_s,
        "positions_per_s": st.tokens / run_s,
        "hit_rate": st.hit_rate, "hits": st.hits, "misses": st.misses,
        "fetch_bytes": st.fetch_bytes, "steps": st.steps,
        "prefill_chunks": st.prefill_chunks,
        "prefill_tokens": st.prefill_tokens,
        "fallback_prefill_tokens": st.fallback_prefill_tokens,
        "sim_stall_s": st.sim_stall_s, "host_bw_bytes_per_s": host_bw,
        "launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "distinct_slots_per_expert_call": distinct_slots(routes, kinds),
        "stream_digest": digest(outs), "route_digest": digest(routes),
    }
    del eng, params, pp
    return result, launches


MAIN_RUN_COUNTERS = ("hit_rate", "hits", "misses", "fetch_bytes",
                     "sim_stall_s", "run_s", "generated_tokens_per_s")


def main_run_trained(torch, np, dev, host_bw, handed, main1):
    """Main run 1 again, the same backbone, prompts and cache, with the
    full-size predictor that the ``pipeline`` phase trained on this
    backbone's traces (``handed``: its params and config). Fails unless
    the streams, the routed ids and the launches equal main run 1's
    (``main1``: its result and launches): the policy moves only weights."""
    result, launches = main_run(torch, np, dev, "deepseek-v2-lite", host_bw,
                                predictor=(handed["pp"], handed["pc"]))
    first, first_launches = main1
    for key in ("stream_digest", "route_digest"):
        if result[key] != first[key]:
            fail(f"main_run_trained: {key} {result[key]} differs from main "
                 f"run 1's {first[key]}")
    if launches != first_launches:
        fail(f"main_run_trained: launches {launches} differ from main run "
             f"1's {first_launches}")
    result["same_streams_routes_launches_as_main_run"] = True
    result["main_run"] = {k: first[k] for k in MAIN_RUN_COUNTERS}
    return result, launches


# the parity runs' modeled host-to-device rate: one value on both sides
# (a parity run compares counters, not this card's rate)
PARITY_HOST_BW = 100e9


def predictor_pair(torch, dev, pc, seed):
    """A full-size predictor drawn on the card: (card copy, CPU copy)."""
    from repro_torch.core.predictor import predictor_init
    pp_cpu = predictor_init(torch.Generator(dev).manual_seed(seed), pc,
                            device="cpu")
    pp_gpu = {k: ([{kk: vv.to(dev) for kk, vv in lp.items()} for lp in v]
                  if k == "enc" else v.to(dev)) for k, v in pp_cpu.items()}
    return pp_gpu, pp_cpu


def check_same(label, card, cpu):
    """card/cpu: (streams, routed ids, EngineStats dict) of one engine."""
    if card[0] != cpu[0]:
        fail(f"{label}GPU/CPU streams differ: {card[0]} vs {cpu[0]}")
    if card[1] != cpu[1]:
        fail(f"{label}GPU/CPU routed expert ids differ")
    if card[2] != cpu[2]:
        fail(f"{label}GPU/CPU EngineStats differ: {card[2]} vs {cpu[2]}")


def parity_run(torch, np, dev):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    cfg = get_config("deepseek-v2-lite").replace(num_layers=3,
                                                 dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    params = model.init(gen, device="cpu")          # drawn on the card
    pc = predictor_config(PredictorConfig, cfg)
    pp_gpu, pp_cpu = predictor_pair(torch, dev, pc, SEED + 3)
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (11, 6)]
    runs = {}
    for where, pp in (("card", pp_gpu), ("cpu", pp_cpu)):
        eng = BatchedOffloadEngine(
            model, params, lambda pp=pp: OnlineMoEBeyondPolicy(pp, pc), 24,
            host_bw=PARITY_HOST_BW, max_batch=2, block_size=8,
            prefill_chunk=8, layer_compute_s=2e-4,
            device=dev if where == "card" else "cpu")
        routes = record_routes(eng.core, check_finite=True)
        outs = eng.generate(prompts, 6, 32)
        eng.pool.check_leaks(expected_in_use=0)
        st = eng.stats.as_dict()
        st.pop("latency")
        runs[where] = (outs, routes, st)
        del eng
    check_same("", runs["card"], runs["cpu"])
    return {"layers": 3, "dtype": "float32", "streams": runs["card"][0],
            "routing_steps": len(runs["card"][1]),
            "stats": runs["card"][2], "identical": True}


# the pipeline phase: prompts from the topic corpus, decode steps per
# trace, predictor training split, and the simulator's cache (the paper's
# 10%) and warm-up prefix
PIPELINE = dict(prompts=32, prompt_len=64, max_new=16, train=24,
                temperature=0.8, capacity_fraction=0.1, warm_tokens=8)


def seven_policies(P, pp, pc, train_traces):
    """The simulator's policies, fresh, in the table's order: LRU alone,
    random, global frequency, MoE-Infinity, cross-layer, MoE-Beyond (the
    predictor ``pp``) and the oracle; the baselines prefetch top-k."""
    n, e, k = pc.num_model_layers, pc.num_experts, pc.top_k
    return [P.NoPrefetchPolicy(), P.RandomPolicy(e, k, seed=SEED),
            P.GlobalFrequencyPolicy(train_traces, n, e, k),
            P.MoEInfinityPolicy(train_traces, n, e, k),
            P.CrossLayerPolicy(train_traces, n, e, k),
            P.MoEBeyondPolicy(pp, pc), P.OraclePolicy()]


def sim_row(r) -> dict:
    return {"cache_hit_rate": r.cache_hit_rate,
            "prediction_hit_rate": r.prediction_hit_rate,
            "est_stall_ms_per_token": r.est_stall_s_per_token * 1e3,
            "demand_fetches": r.demand_fetches, "prefetches": r.prefetches,
            "tokens": r.tokens}


def since(torch, t0) -> float:
    """Seconds since ``t0`` once the card has finished its work."""
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def trace_backbone(torch, np, dev, label, model, params):
    """Step 2 of the pipeline: ``PIPELINE``'s batch-1 traces of topic-
    corpus prompts (``n_topics=8``, seed 0) through the facade's decode
    mode, prompt i sampled from a generator seeded with SEED + i. Fails
    unless ``topk_gating`` and ``expert_ffn`` each launched exactly once
    per MoE layer and step (and no other kernel ran) and every trace is
    well formed. Returns (traces, seconds, launches)."""
    from repro_torch.core.tracing import collect_traces, moe_layer_ids
    from repro_torch.data import make_topic_corpus, sample_prompts
    from repro_torch.kernels import launch_counts, reset_launch_counts

    c, cfg = PIPELINE, model.cfg
    m = cfg.moe
    n_moe = len(moe_layer_ids(cfg))
    cache_len = c["prompt_len"] + c["max_new"]
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=8, seed=0)
    prompts = sample_prompts(corpus, c["prompts"], c["prompt_len"], seed=2)
    reset_launch_counts()
    t0 = time.perf_counter()
    traces = collect_traces(model, params, prompts, c["max_new"], cache_len,
                            c["temperature"], seed=SEED)
    trace_s = since(torch, t0)
    launches = launch_counts()
    steps = sum(t.num_tokens for t in traces)
    want = {k: 0 for k in launches}
    want["topk_gating"] = want["expert_ffn"] = steps * n_moe
    if launches != want:
        fail(f"{label}: launches {launches}, want {want}")
    for tr in traces:
        if (tr.experts.shape != (cache_len, n_moe, m.top_k)
                or tr.prompt_len != c["prompt_len"]
                or not (0 <= tr.tokens).all()
                or not (tr.tokens < cfg.vocab_size).all()
                or not ((0 <= tr.experts) & (tr.experts < m.num_experts))
                .all()
                or not all(len(set(r)) == m.top_k
                           for r in tr.experts.reshape(-1, m.top_k))
                or not np.isfinite(tr.embeddings).all()):
            fail(f"{label}: a malformed trace")
    return traces, trace_s, launches


def predict_and_simulate(torch, np, dev, label, cfg, traces, fractions):
    """Steps 3-4 of the pipeline on ``traces``: the paper's full-size
    predictor trained on the first ``PIPELINE["train"]`` with
    ``train_predictor``'s defaults, then the others replayed through the
    cache simulator with every policy at each cache fraction, together
    and one trace at a time (the spread that says whether the table ranks
    the policies), at the host-to-device rate of this card. Fails unless
    every loss is finite, the trained predictor's validation loss is
    below the untrained one's and the oracle hits every access. Returns
    (result, {cache fraction: (table, slots)}, {"pp": trained predictor,
    "init": its initial weights, "pc": its config})."""
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core import policies as P
    from repro_torch.core.predictor import predictor_init
    from repro_torch.core.predictor_train import evaluate, train_predictor
    from repro_torch.core.simulator import (SimConfig, expert_bytes,
                                            measured_host_bw, simulate)
    from repro_torch.data import PredictorDataset

    c, m = PIPELINE, cfg.moe
    n_moe = len(traces[0].experts[0])
    cache_len = c["prompt_len"] + c["max_new"]
    train_tr, held_out = traces[:c["train"]], traces[c["train"]:]

    # 3. predictor: initial weights, then dropout, from one generator
    pc = predictor_config(PredictorConfig, cfg).replace(max_seq=cache_len)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    init = predictor_init(gen, pc, device=dev)
    lines = []
    t0 = time.perf_counter()
    pp, hist = train_predictor(train_tr, held_out, pc, device=dev,
                               generator=gen, init_params=init,
                               log=lines.append)
    train_s = since(torch, t0)
    for line in lines:
        log(f"{label}: {line}")
    ds_val = PredictorDataset(held_out, pc)
    untrained, trained = evaluate(init, pc, ds_val), evaluate(pp, pc, ds_val)
    losses = hist.train_loss + hist.val_loss
    if not losses or not np.isfinite(losses).all():
        fail(f"{label}: non-finite predictor losses {losses}")
    if not (np.isfinite(untrained["loss"]) and np.isfinite(trained["loss"])):
        fail(f"{label}: non-finite validation loss {untrained} {trained}")
    if not trained["loss"] < untrained["loss"]:
        fail(f"{label}: trained validation loss {trained['loss']} is not "
             f"below the untrained predictor's {untrained['loss']}")

    # 4. simulator, at the host-to-device rate of this card
    nbytes = expert_bytes(cfg)
    host_bw = measured_host_bw(dev, nbytes)
    t0 = time.perf_counter()
    tables = {}
    for frac in fractions:
        sim = SimConfig(num_layers=n_moe, num_experts=m.num_experts,
                        capacity_fraction=frac,
                        warm_tokens=c["warm_tokens"], expert_bytes=nbytes,
                        host_bw=host_bw)
        table = {}
        for pol in seven_policies(P, pp, pc, train_tr):
            r = simulate(held_out, pol, sim)
            table[r.policy] = sim_row(r)
        if table["oracle"]["cache_hit_rate"] != 1.0:
            fail(f"{label}: the oracle's cache-hit rate at {frac:.0%} is "
                 f"{table['oracle']['cache_hit_rate']}, not 1.0")
        for tr in held_out:
            for pol in seven_policies(P, pp, pc, train_tr):
                table[pol.name].setdefault("per_trace_cache_hit_rate", []) \
                    .append(simulate([tr], pol, sim).cache_hit_rate)
        for row in table.values():
            rates = np.asarray(row["per_trace_cache_hit_rate"])
            row["per_trace_std"] = float(rates.std(ddof=1))
            row["std_error"] = row["per_trace_std"] / len(rates) ** 0.5
        tables[frac] = (table, max(1, int(round(frac * n_moe
                                                * m.num_experts))))
    sim_s = since(torch, t0)
    return {
        "held_out_traces": len(held_out),
        "measured_tokens": len(held_out) * (cache_len - c["warm_tokens"]),
        "predictor": {"d_model": pc.d_model, "layers": pc.num_layers,
                      "heads": pc.num_heads, "d_ff": pc.d_ff,
                      "dropout": pc.dropout, "max_seq": pc.max_seq},
        "train_s": train_s, "train_steps": hist.steps,
        "epochs": len(hist.train_loss),
        "last_epoch": {"train_loss": hist.train_loss[-1],
                       "train_acc": hist.train_acc[-1],
                       "train_f1": hist.train_f1[-1],
                       "val_loss": hist.val_loss[-1],
                       "val_acc": hist.val_acc[-1],
                       "val_exact": hist.val_exact[-1],
                       "val_f1": hist.val_f1[-1]},
        "val_loss_by_epoch": hist.val_loss,
        "untrained_val": untrained, "trained_val": trained,
        "host_bw_bytes_per_s": host_bw, "expert_bytes": nbytes,
        "sim_s": sim_s}, tables, {"pp": pp, "init": init, "pc": pc}


def pipeline_run(torch, np, dev, keep):
    """The paper's pipeline, steps 2-4 of the quickstart, on main run 1's
    backbone (full width and depth, bfloat16, main run 1's seed) with
    every expert on the device: batch-1 traces through the facade's
    decode mode (``topk_gating`` and ``expert_ffn`` on every MoE layer of
    every step), the paper's full-size predictor trained with
    ``train_predictor``'s defaults, and the held-out traces replayed
    through the cache simulator with every policy at a 10% cache. The
    trained predictor and its config go to ``keep["pipeline"]`` for
    ``main_run_trained``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    c = PIPELINE
    cfg = get_config("deepseek-v2-lite")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED), device=dev)
    init_s = since(torch, t0)
    param_bytes = sum(t.numel() * t.element_size() for t in tensors(params))
    traces, trace_s, launches = trace_backbone(torch, np, dev, "pipeline",
                                               model, params)
    del params
    release_host_memory(torch)
    steps = sum(t.num_tokens for t in traces)
    out, tables, trained = predict_and_simulate(
        torch, np, dev, "pipeline", cfg, traces, (c["capacity_fraction"],))
    keep["pipeline"] = {"pp": trained["pp"], "pc": trained["pc"]}
    table, slots = tables[c["capacity_fraction"]]
    result = {
        "config": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
        "moe_layers": len(traces[0].experts[0]),
        "param_bytes_on_device": param_bytes, "init_s": init_s, **c,
        "cache_len": c["prompt_len"] + c["max_new"], "traces": len(traces),
        "decode_steps": steps, "trace_s": trace_s,
        "trace_steps_per_s": steps / trace_s,
        "trace_launches": {k: launches[k]
                           for k in ("topk_gating", "expert_ffn")},
        "launches_per_step": {k: launches[k] / steps
                              for k in ("topk_gating", "expert_ffn")},
        **out, "capacity_slots": slots, "policies": table,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    return result, launches


# the train phase: DeepSeek-V2-Lite at full width in bfloat16, depth cut
# to 4 layers (1 dense, 3 MoE: ~27 GB of weights, gradients and float32
# moments; 27 layers would need ~190 GB), one dispatch group of 4,096
# tokens a step (capacity 480 pairs an expert), AdamW without a schedule
TRAIN = dict(layers=4, batch=4, seq=1024, steps=8, lr=1e-3)


def train_run(torch, np, dev):
    """Full-width DeepSeek-V2-Lite trained ``TRAIN["steps"]`` AdamW steps
    (clip 1.0) from seeded weights on the 8-topic corpus at vocab 102,400
    (B 4 x S 1024: the chunked loss runs, B S V > 2^28). One untimed
    forward first (its router launches counted apart). Fails unless every
    loss is finite, the last is below the first, and ``topk_gating``
    launched exactly once per MoE layer and step, no other kernel."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches, make_topic_corpus
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train_step, trainable
    from repro_torch.models import model as model_mod
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import moe_layer_ids
    from repro_torch.training.optimizer import make_adamw

    c = TRAIN
    cfg = get_config("deepseek-v2-lite").replace(num_layers=c["layers"])
    n_moe = len(moe_layer_ids(cfg))
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, leaves = trainable(
        model.init(torch.Generator(dev).manual_seed(SEED), device=dev))
    opt_init, opt_update = make_adamw(lr=c["lr"], clip=1.0)
    opt_state = opt_init(params)
    init_s = since(torch, t0)
    n_params = sum(t.numel() for t in leaves)
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=8, seed=0)
    batches = [torch.as_tensor(b[:, :c["seq"]], device=dev)
               for b in lm_batches(corpus, c["batch"], c["seq"],
                                   c["steps"], seed=1)]
    tokens = c["batch"] * c["seq"]
    if not tokens * cfg.vocab_size > model_mod._XENT_CHUNK_BUDGET:
        fail("train: the batch does not reach the chunked loss")
    reset_launch_counts()
    with torch.no_grad():
        model.loss_fn(params, {"tokens": batches[0]})
    warmup_launches = launch_counts()
    torch.cuda.synchronize()
    reset_launch_counts()
    steps = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        opt_state, loss, mets, gnorm = train_step(
            model, params, leaves, opt_update, opt_state, batch)
        step_s = since(torch, t0)
        steps.append({"loss": loss.item(), "xent": mets["xent"].item(),
                      "moe_aux": mets["moe_aux"].item(),
                      "grad_norm": gnorm.item(), "s": step_s,
                      "tokens_per_s": tokens / step_s,
                      "max_memory_allocated_bytes":
                          torch.cuda.max_memory_allocated()})
        log(f"train: step {i} loss {steps[-1]['loss']:.4f} "
            f"{step_s:.3f} s {tokens / step_s:.0f} tokens/s")
    launches = launch_counts()
    losses = [st["loss"] for st in steps]
    if not np.isfinite(losses).all():
        fail(f"train: non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: the last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    want = {k: 0 for k in launches}
    want["topk_gating"] = n_moe * c["steps"]
    if launches != want:
        fail(f"train: launches {launches}, want {want}")
    timed = sorted(st["s"] for st in steps[1:])
    result = {
        "config": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
        "full_depth": get_config("deepseek-v2-lite").num_layers,
        "moe_layers": n_moe, "params": n_params,
        "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
        "moment_bytes": 8 * n_params, **c, "tokens_per_step": tokens,
        "dispatch_capacity": capacity(cfg, tokens), "init_s": init_s,
        "losses": losses, "steps_detail": steps,
        "median_s_per_step_after_first": timed[len(timed) // 2],
        "median_tokens_per_s_after_first": tokens / timed[len(timed) // 2],
        "warmup_launches": warmup_launches, "launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del params, leaves, opt_state, batches
    return result, launches


# a router decision closer than this (k-th against (k+1)-th probability)
# is a near-tie that float32 rounding may settle either way on two devices
NEAR_TIE = 1e-6


def parity_run_train(torch, np, dev):
    """The reduced DeepSeek-V2-Lite in float32 (TF32 off), the same
    seeded weights on the card and on the CPU: one ``loss_fn`` on the
    quickstart's first batch (16 x 64, 4-topic corpus) with its routed ids
    and gradients, then 3 of the quickstart's AdamW steps (3e-3, clip 1.0)
    on the next batches. Each step starts both devices from the CPU's
    weights and moments, so a difference cannot carry over from one step
    to the next. Routed ids of the first batch identical, its loss within
    1e-5 relative, every gradient within 1e-4 of its largest entry.

    Each step where both devices routed every token identically is held
    twice. The update alone: the card's new weights and moments against
    the CPU's AdamW applied to the card's own gradients from the same
    start, every leaf within 1e-5 of its largest entry. The trajectory:
    the step's loss within 1e-4, its gradient norm within 1e-4 relative,
    every gradient, moment and new weight within 1e-4 of its leaf's
    largest entry against the CPU's step. (From zero moments AdamW's
    first update is ``lr * sign(g)``, so there an entry whose gradient is
    within the gradient tolerance of 0 may move ``2 * lr`` apart.) A step
    whose routing differs must differ first at near-ties only (in the
    first MoE layer that differs, the CPU's k-th and (k+1)-th
    probabilities of every differing row within ``NEAR_TIE``); it is
    reported, not compared."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import lm_batches, make_topic_corpus
    from repro_torch.launch.train import train_step, trainable
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import (make_adamw, named_leaves,
                                                tree_map)

    cfg = get_reduced("deepseek-v2-lite")
    k = cfg.moe.top_k
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 21),
                        device="cpu")                 # drawn on the card
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=4, seed=0)
    batches = [torch.from_numpy(b[:, :64])
               for b in lm_batches(corpus, 16, 64, 4, seed=1)]
    route, routes = moe_mod.route_train, []

    def recording(p, cfg_, x):       # each MoE layer's (ids, probs)
        w, idx, probs = route(p, cfg_, x)
        routes.append((idx.detach().reshape(-1, k).cpu(),
                       probs.detach().reshape(-1, probs.shape[-1]).cpu()))
        return w, idx, probs

    def copy(tree, d):
        return tree_map(lambda t: t.detach().to(d, copy=True), tree)

    def near_tie(rc, rp):
        """None when both devices routed alike, else the split's record;
        fails unless the first differing layer differs at near-ties."""
        differ = [j for j, ((a, _), (b, _)) in enumerate(zip(rc, rp))
                  if not torch.equal(a, b)]
        if not differ:
            return None
        j = differ[0]
        rows = (rc[j][0] != rp[j][0]).any(-1)
        top = rp[j][1][rows].sort(-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).max().item()
        if not gap <= NEAR_TIE:
            fail(f"parity_train: {int(rows.sum())} rows of MoE layer {j} "
                 f"routed apart at a probability gap of {gap} > {NEAR_TIE}")
        return {"moe_layer": j, "rows": int(rows.sum()),
                "largest_gap": gap}

    def of_max(a, b):       # largest |a - b| over largest |b|
        return ((a.cpu() - b).abs().max().item()
                / max(b.abs().max().item(), 1e-30))

    def leaves_of(p, state):
        return {"param": [t for _, t in named_leaves(p)],
                "mu": state["mu"], "nu": state["nu"]}

    lr = 3e-3
    opt_init, adamw = make_adamw(lr=lr, clip=1.0)
    kept = []

    def opt_update(grads, state, p):    # AdamW, keeping the gradients
        kept[:] = grads
        return adamw(grads, state, p)

    first = {}
    steps = []
    moe_mod.route_train = recording
    try:
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            p, leaves = trainable(copy(params, d))
            routes.clear()
            loss, _ = model.loss_fn(p, {"tokens": batches[0].to(d)})
            first[where] = ([i for i, _ in routes], loss.item(),
                            [g.cpu() for g in torch.autograd.grad(loss,
                                                                  leaves)])
        cpu_p, cpu_leaves = trainable(copy(params, "cpu"))
        cpu_state = opt_init(cpu_p)
        for b in batches[1:]:
            start = copy(cpu_p, "cpu"), copy(cpu_state, "cpu")
            card_p, card_leaves = trainable(copy(cpu_p, dev))
            card_state = copy(cpu_state, dev)
            routes.clear()
            card_state, lc, _, gc = train_step(
                model, card_p, card_leaves, opt_update, card_state, b.to(dev))
            card_g = [g.cpu() for g in kept]
            rc = list(routes)
            routes.clear()
            cpu_state, lp, _, gp = train_step(model, cpu_p, cpu_leaves,
                                              opt_update, cpu_state, b)
            cpu_g = list(kept)
            ref_p, ref_state, _ = adamw(card_g, start[1], start[0])
            card = leaves_of(card_p, card_state)
            ref = leaves_of(ref_p, ref_state)
            steps.append({
                "loss": (lc.item(), lp.item()),
                "grad_norm": (gc.item(), gp.item()),
                "from_zero_moments": int(start[1]["step"]) == 0,
                "update": {kind: [of_max(a, b) for a, b in zip(
                    card[kind], ref[kind])] for kind in card},
                "grad": [of_max(a, b) for a, b in zip(card_g, cpu_g)],
                "moments": [of_max(a, b) for kind in ("mu", "nu")
                            for a, b in zip(card[kind], cpu_state[kind])],
                "param": (card["param"],
                          [t.detach().clone()
                           for _, t in named_leaves(cpu_p)],
                          cpu_g),
                "split": near_tie(rc, list(routes))})
    finally:
        moe_mod.route_train = route
    card, cpu = first["card"], first["cpu"]
    if not all(torch.equal(a, b) for a, b in zip(card[0], cpu[0])):
        fail("parity_train: GPU/CPU routed expert ids differ")
    if not abs(card[1] - cpu[1]) <= 1e-5 * abs(cpu[1]):
        fail(f"parity_train: losses {card[1]} vs {cpu[1]}")
    worst = 0.0
    for (path, _), a, b in zip(named_leaves(params), card[2], cpu[2]):
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        worst = max(worst, err)
        if not err <= 1e-4:
            fail(f"parity_train: gradient {path} differs by {err} of its "
                 "largest entry > 1e-4")
    names = [path for path, _ in named_leaves(params)]
    compared, worst_update, worst_step = [], 0.0, 0.0
    for s, st in enumerate(steps):
        if st["split"] is not None:
            continue
        (lc, lp), (gc, gp) = st["loss"], st["grad_norm"]
        if not (abs(lc - lp) <= 1e-4 and abs(gc - gp) <= 1e-4 * abs(gp)):
            fail(f"parity_train: step {s}: losses {lc} vs {lp}, gradient "
                 f"norms {gc} vs {gp}")
        for kind, errs in st["update"].items():
            for path, err in zip(names, errs):
                worst_update = max(worst_update, err)
                if not err <= 1e-5:
                    fail(f"parity_train: step {s}: the card's AdamW {kind} "
                         f"of {path} differs from the CPU's on the same "
                         f"gradients by {err} of its largest entry > 1e-5")
        for what, errs in (("gradient", st["grad"]),
                           ("moment", st["moments"])):
            for path, err in zip(names * 2, errs):
                worst_step = max(worst_step, err)
                if not err <= 1e-4:
                    fail(f"parity_train: step {s}: {what} of {path} differs "
                         f"by {err} of its largest entry > 1e-4")
        for path, a, b, g in zip(names, *st["param"]):
            diff = (a.cpu() - b).abs()
            allowed = torch.full_like(b, 1e-4 * b.abs().max().item())
            if st["from_zero_moments"]:   # lr * sign(g) at a rounding of 0
                tie = g.abs() <= 1e-4 * g.abs().max()
                allowed = torch.where(tie, allowed + 2 * lr, allowed)
            worst_step = max(worst_step, of_max(a, b))
            if not bool((diff <= allowed).all()):
                fail(f"parity_train: step {s}: weights of {path} differ by "
                     f"{of_max(a, b)} of their largest entry")
        compared.append(abs(lc - lp))
    if not compared:
        fail("parity_train: no step routed alike on both devices")
    return {"config": cfg.name, "dtype": cfg.dtype, "batch": [16, 64],
            "identical_ids": True, "loss": cpu[1],
            "loss_rel_err": abs(card[1] - cpu[1]) / abs(cpu[1]),
            "worst_grad_err_of_max": worst,
            "step_losses": [st["loss"][0] for st in steps],
            "step_losses_cpu": [st["loss"][1] for st in steps],
            "step_grad_norms": [st["grad_norm"][0] for st in steps],
            "step_grad_norms_cpu": [st["grad_norm"][1] for st in steps],
            "steps_compared": len(compared),
            "max_step_loss_err": max(compared),
            "worst_update_err_of_max": worst_update,
            "worst_step_err_of_max": worst_step,
            "routing_splits": {s: st["split"] for s, st in enumerate(steps)
                               if st["split"] is not None},
            "tolerances": {"loss_rel": 1e-5, "grad_of_max": 1e-4,
                           "step_loss": 1e-4, "step_grad_norm_rel": 1e-4,
                           "update_of_max": 1e-5, "step_of_max": 1e-4,
                           "near_tie": NEAR_TIE}}


# the trained backbone of the pipeline: the ~100M config trained with the
# reference launcher's recipe, as examples/train_backbone.py runs it
BACKBONE = dict(steps=200, batch=8, seq=256, lr=3e-3)
TRAINED_FRACTIONS = (0.1, 0.2)


def pipeline_trained_run(torch, np, dev, random_table, keep):
    """The pipeline on a trained backbone: the ~100M config of
    ``examples/train_backbone.py`` (float32) trained ``BACKBONE`` steps by
    ``launch.train`` (AdamW 3e-3, clip 1.0, cosine with 20 warm-up steps,
    the 8-topic corpus), then the ``pipeline`` phase's steps 2-4 at 10%
    and 20% caches. Fails unless every backbone loss is finite and the
    last below the first, and the steps' own checks pass. Whether the
    predictor learned anything (F1 above 0, MoE-Beyond's prediction hits
    above random's) is reported, not required: ``random_table`` is the
    random-backbone ``pipeline`` phase's table, printed beside. What
    ``serve_trained`` serves goes to ``keep["pipeline_trained"]``: the
    trained backbone, the training traces, the held-out traces' prompts,
    the trained predictor, its initial weights and config, the measured
    host rate and the simulator's tables."""
    from repro_torch.configs.deepseek_v2_lite import hundred_m_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import moe_layer_ids

    b = BACKBONE
    cfg = hundred_m_config()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    lines = []
    reset_launch_counts()
    t0 = time.perf_counter()
    params, losses = train(cfg, steps=b["steps"], batch_size=b["batch"],
                           seq_len=b["seq"], lr=b["lr"], seed=SEED,
                           device=dev, log=lines.append)
    backbone_s = since(torch, t0)
    backbone_launches = launch_counts()
    want = {k: 0 for k in backbone_launches}
    want["topk_gating"] = b["steps"] * len(moe_layer_ids(cfg))
    if backbone_launches != want:
        fail(f"pipeline_trained: training launches {backbone_launches}, "
             f"want {want}")
    for line in lines:
        log(f"pipeline_trained: {line}")
    if not np.isfinite(losses).all():
        fail(f"pipeline_trained: non-finite backbone losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"pipeline_trained: the last backbone loss {losses[-1]} is not "
             f"below the first {losses[0]}")
    traces, trace_s, launches = trace_backbone(
        torch, np, dev, "pipeline_trained", model, params)
    steps = sum(t.num_tokens for t in traces)
    out, tables, trained = predict_and_simulate(
        torch, np, dev, "pipeline_trained", cfg, traces, TRAINED_FRACTIONS)
    rows = {f"{frac:.0%}": {"capacity_slots": slots, "policies": table}
            for frac, (table, slots) in tables.items()}
    t10 = tables[0.1][0]
    result = {
        "config": "hundred_m_config (examples/train_backbone.py)",
        "dtype": cfg.dtype, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
        "top_k": cfg.moe.top_k,
        "params": sum(t.numel() for t in tensors(params)), **b,
        "backbone_s": backbone_s, "backbone_launches": backbone_launches,
        "backbone_losses": losses,
        "loss_curve": {i: losses[i] for i in
                       list(range(0, len(losses), 20)) + [len(losses) - 1]},
        "traces": len(traces), "decode_steps": steps, "trace_s": trace_s,
        "trace_steps_per_s": steps / trace_s,
        "trace_launches": {k: launches[k]
                           for k in ("topk_gating", "expert_ffn")},
        **out, "caches": rows,
        "random_backbone_10%": {
            k: {"cache_hit_rate": v["cache_hit_rate"],
                "std_error": v["std_error"],
                "prediction_hit_rate": v["prediction_hit_rate"]}
            for k, v in random_table.items()},
        "shape_holds": {
            "f1_above_0": out["last_epoch"]["val_f1"] > 0,
            "moe_beyond_prediction_hits_above_random": (
                t10["moe-beyond"]["prediction_hit_rate"]
                > t10["random"]["prediction_hit_rate"])},
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    n_train = PIPELINE["train"]
    keep["pipeline_trained"] = {
        "model": model, "params": params, "train_traces": traces[:n_train],
        "prompts": [tr.tokens[:tr.prompt_len].tolist()
                    for tr in traces[n_train:]],
        **trained, "host_bw": out["host_bw_bytes_per_s"], "sim": rows}
    return result, launches


# serve_trained: the held-out prompts served greedily by the engines for
# the traces' PIPELINE["max_new"] new tokens (the reference's engine bench:
# a 50 us layer-compute clock), batch 1 at both of pipeline_trained's
# caches with every launcher policy at width top-k (the simulator table's)
# and the untrained predictor as a control, then the batched engine at the
# 10% cache. Batch 1 serves the first 4 of the 8 held-out prompts: on an
# H100 80GB HBM3 (700 W) the batch-1 engine runs ~55 positions/s on this
# backbone (~23 with the learned policy's 7 predictor forwards a step), so
# all 8 would take ~250 s
SERVE = dict(layer_compute_s=50e-6, max_batch=4, block_size=8,
             prefill_chunk=8, batch1_prompts=4)
SERVE_POLICIES = ("none", "random", "next-layer-all", "global-frequency",
                  "moe-infinity", "moe-beyond", "moe-beyond-untrained")
SERVE_BATCHED = ("none", "moe-beyond")
# engine policy -> the simulator row it stands beside
SIM_ROW = {"none": "lru-on-demand", "random": "random",
           "global-frequency": "global-frequency",
           "moe-infinity": "moe-infinity", "moe-beyond": "moe-beyond"}


def serve_one(torch, dev, handed, engine, frac, label, prompts):
    """One engine run of ``serve_trained``: ``prompts`` through the batch-1
    ``OffloadEngine`` (one policy instance, the prompts in turn) or the
    batched engine (a policy per request). Fails unless
    ``topk_gating`` and ``expert_ffn`` launched once per MoE layer of each
    step and prefill chunk, ``paged_flash_decode`` once per layer of each
    in the batched engine and never at batch 1, nothing else, and hits +
    misses equal the routed (token, MoE layer, expert) accesses. Returns
    (row, streams, routed ids)."""
    from repro_torch.core.tracing import moe_layer_ids
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_policy
    from repro_torch.serving.engine import OffloadEngine
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    c, h = SERVE, handed
    max_new = PIPELINE["max_new"]
    cache_len = len(prompts[0]) + max_new + 1
    model = h["model"]
    cfg = model.cfg
    k = cfg.moe.top_k
    n_moe = len(moe_layer_ids(cfg))
    name = label.replace("-untrained", "")
    pp = h["init"] if label.endswith("-untrained") else h["pp"]

    def policy():
        return build_policy(name, cfg, h["train_traces"], width=k,
                            predictor=pp, pcfg=h["pc"])
    capacity = max(1, int(frac * n_moe * cfg.moe.num_experts))
    if engine == "batch-1":
        eng = OffloadEngine(model, h["params"], policy(), capacity,
                            host_bw=h["host_bw"],
                            layer_compute_s=c["layer_compute_s"], device=dev)
    else:
        capacity = max(c["max_batch"] * k, capacity)
        eng = BatchedOffloadEngine(
            model, h["params"], policy, capacity, host_bw=h["host_bw"],
            max_batch=c["max_batch"], block_size=c["block_size"],
            prefill_chunk=c["prefill_chunk"],
            layer_compute_s=c["layer_compute_s"], device=dev)
    routes = record_routes(eng.core, check_finite=True)
    where = f"serve_trained ({engine}, {frac:.0%}, {label})"
    reset_launch_counts()
    t0 = time.perf_counter()
    if engine == "batch-1":
        outs = [eng.generate(p, max_new, cache_len) for p in prompts]
    else:
        outs = eng.generate(prompts, max_new, cache_len)
    run_s = since(torch, t0)
    launches = launch_counts()
    st = eng.stats
    calls = st.steps + st.prefill_chunks
    want = {kernel: 0 for kernel in launches}
    want["topk_gating"] = want["expert_ffn"] = n_moe * calls
    if engine == "batched":
        want["paged_flash_decode"] = cfg.num_layers * calls
        eng.pool.check_leaks(expected_in_use=0)
    if launches != want:
        fail(f"{where}: launches {launches}, want {want}")
    accesses = sum(len(g) for entry in routes for r in entry for g in r)
    if st.hits + st.misses != accesses:
        fail(f"{where}: hits + misses {st.hits} + {st.misses} != "
             f"{accesses} routed accesses")
    generated = sum(len(o) for o in outs)
    if any(len(o) != max_new + 1 for o in outs):
        fail(f"{where}: a stream of the wrong length: {outs}")
    cs = eng.core.cache.stats
    row = {"capacity_slots": capacity, "policy": label,
           "requests": len(prompts),
           "hit_rate": st.hit_rate, "hits": st.hits, "misses": st.misses,
           "prefetch_hits": cs.prefetch_hits,
           "prefetch_hit_share": cs.prefetch_hits / max(cs.accesses, 1),
           "prefetches": cs.prefetches, "fetch_bytes": st.fetch_bytes,
           "fetch_mib": st.fetch_bytes / 2**20,
           "sim_stall_s": st.sim_stall_s,
           "blocking_stall_s": st.blocking_stall_s,
           "overlapped_s": st.overlapped_s, "run_s": run_s,
           "generated_tokens": generated,
           "generated_tokens_per_s": generated / run_s,
           "positions_per_s": st.tokens / run_s, "steps": st.steps,
           "prefill_chunks": st.prefill_chunks, "launches": launches}
    if engine == "batched":
        row["prefill_chunk"] = eng.prefill_chunk
    del eng
    return row, outs, routes


def serve_trained_run(torch, np, dev, handed):
    """The deployment loop with a trained predictor: ``pipeline_trained``'s
    backbone serving held-out prompts, whose traces its simulator
    replayed, greedy (``SERVE``), through ``serve_one``: batch 1 at the 10%
    and 20% caches with every ``SERVE_POLICIES`` entry, then batched at
    10% with ``SERVE_BATCHED``. Fails unless, within each engine, every
    policy's streams and routed ids equal the ``none`` run's. Each row
    stands beside the simulator's hit rate for the same policy and cache
    over the traces of the same prompts (± their standard error) and over
    all 8; whether the two rank the policies alike is reported, not
    required."""
    runs, launches = [], {}
    every = handed["prompts"]
    for engine, fracs, names, prompts in (
            ("batch-1", TRAINED_FRACTIONS, SERVE_POLICIES,
             every[:SERVE["batch1_prompts"]]),
            ("batched", (0.1,), SERVE_BATCHED, every)):
        base = None
        for frac in fracs:
            sim = handed["sim"][f"{frac:.0%}"]["policies"]
            for label in names:
                row, outs, routes = serve_one(torch, dev, handed, engine,
                                              frac, label, prompts)
                if base is None:
                    base = (outs, routes)
                elif outs != base[0]:
                    fail(f"serve_trained ({engine}, {frac:.0%}, {label}): "
                         f"streams differ from the none run's")
                elif routes != base[1]:
                    fail(f"serve_trained ({engine}, {frac:.0%}, {label}): "
                         f"routed ids differ from the none run's")
                row.update(engine=engine, cache=f"{frac:.0%}",
                           sim_cache_hit_rate=None, sim_std_error=None,
                           sim_cache_hit_rate_all=None)
                sim_row = sim.get(SIM_ROW.get(label, ""))
                if sim_row is not None:   # the same prompts' traces
                    rates = np.asarray(
                        sim_row["per_trace_cache_hit_rate"][:len(prompts)])
                    row.update(
                        sim_cache_hit_rate=float(rates.mean()),
                        sim_std_error=float(rates.std(ddof=1)
                                            / len(rates) ** 0.5),
                        sim_cache_hit_rate_all=sim_row["cache_hit_rate"])
                runs.append(row)
                for key, n in row["launches"].items():
                    launches[key] = launches.get(key, 0) + n
                log(f"serve_trained: {engine} {frac:.0%} {label}: hit "
                    f"{row['hit_rate']:.4f} (sim {row['sim_cache_hit_rate']})"
                    f" {row['run_s']:.1f} s")
    ranking = {}
    for frac in TRAINED_FRACTIONS:
        rows = {r["policy"]: r for r in runs if r["engine"] == "batch-1"
                and r["cache"] == f"{frac:.0%}" and r["policy"] in SIM_ROW}
        order = [sorted(rows, key=lambda p: -rows[p][key])
                 for key in ("hit_rate", "sim_cache_hit_rate")]
        pairs = [(a, b) for i, a in enumerate(rows) for b in list(rows)[i + 1:]]
        agree = sum((rows[a]["hit_rate"] - rows[b]["hit_rate"])
                    * (rows[a]["sim_cache_hit_rate"]
                       - rows[b]["sim_cache_hit_rate"]) > 0
                    for a, b in pairs)
        ranking[f"{frac:.0%}"] = {"engine": order[0], "simulator": order[1],
                                  "same_order": order[0] == order[1],
                                  "pairs_ordered_alike": agree,
                                  "pairs": len(pairs)}
    c = SERVE
    return {"config": "hundred_m_config (examples/train_backbone.py)",
            "requests": len(every), "prompt_len": len(every[0]),
            "max_new": PIPELINE["max_new"],
            "cache_len": len(every[0]) + PIPELINE["max_new"] + 1,
            **c,
            "width": handed["pc"].top_k,
            "host_bw_bytes_per_s": handed["host_bw"],
            "streams_and_routes_identical_across_policies": True,
            "runs": runs, "ranking": ranking}, launches


def parity_run_pipeline(torch, np, dev):
    """The pipeline in float32 on the reduced DeepSeek-V2-Lite (TF32 off):
    greedy traces from the same seeded weights on the card and on the
    CPU must be identical (tokens, routed ids, embeddings), the paper's
    predictor logits on them within 1e-4, and the simulator's table of
    every policy identical."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core import policies as P
    from repro_torch.core.predictor import predictor_apply
    from repro_torch.core.simulator import SimConfig, expert_bytes, simulate
    from repro_torch.core.tracing import collect_traces, moe_layer_ids
    from repro_torch.data import make_topic_corpus, sample_prompts
    from repro_torch.models.model import build_model

    tol = 1e-4
    cfg = get_reduced("deepseek-v2-lite")
    m = cfg.moe
    n_moe = len(moe_layer_ids(cfg))
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 11),
                        device="cpu")                 # drawn on the card
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=4, seed=0)
    prompts = sample_prompts(corpus, 8, 12, seed=2)
    pc = predictor_config(PredictorConfig, cfg).replace(max_seq=24)
    pp_gpu, pp_cpu = predictor_pair(torch, dev, pc, SEED + 12)
    sim = SimConfig(num_layers=n_moe, num_experts=m.num_experts,
                    capacity_fraction=0.25, warm_tokens=4,
                    expert_bytes=expert_bytes(cfg), host_bw=25e9,
                    layer_compute_s=1e-6)
    runs = {}
    for where, p, pp in (("card", to_device(params, dev), pp_gpu),
                         ("cpu", params, pp_cpu)):
        traces = collect_traces(model, p, prompts, 12, 24, temperature=0.0)
        d = pp["in_w"].device
        with torch.no_grad():
            logits = [predictor_apply(
                pp, pc,
                torch.from_numpy(tr.embeddings[None]).expand(
                    n_moe, -1, -1).to(d),
                torch.arange(n_moe, device=d)[:, None].expand(
                    n_moe, tr.num_tokens),
                torch.ones((n_moe, tr.num_tokens), dtype=torch.bool,
                           device=d)).cpu() for tr in traces]
        table = {}
        for pol in seven_policies(P, pp, pc, traces[:5]):
            r = simulate(traces[5:], pol, sim)
            table[r.policy] = sim_row(r)
        runs[where] = (traces, torch.stack(logits), table)
    card, cpu = runs["card"], runs["cpu"]
    for a, b in zip(card[0], cpu[0]):
        if not (np.array_equal(a.tokens, b.tokens)
                and np.array_equal(a.experts, b.experts)
                and np.array_equal(a.embeddings, b.embeddings)
                and a.prompt_len == b.prompt_len):
            fail("parity_pipeline: GPU/CPU traces differ")
    err = (card[1] - cpu[1]).abs().max().item()
    if not err <= tol:
        fail(f"parity_pipeline: predictor logits differ by {err} > {tol}")
    if card[2] != cpu[2]:
        fail(f"parity_pipeline: GPU/CPU simulator tables differ: {card[2]} "
             f"vs {cpu[2]}")
    return {"config": cfg.name, "dtype": cfg.dtype, "traces": len(prompts),
            "trace_tokens": [int(t.num_tokens) for t in card[0]],
            "identical_traces": True, "max_abs_logit_err": err,
            "tolerance": tol, "logit_abs_max": cpu[1].abs().max().item(),
            "identical_tables": True, "table": card[2]}


def parity_run_llama4(torch, np, dev):
    """Llama-4-Scout at full width in float32, cut to the reference's own
    reduced pattern (one chunked and one global layer) with a 16-slot
    chunk, so the chunked ring wraps twice in a 38-position request and
    both attention kernels run. Three engines on identical weights — paged
    ``BatchedOffloadEngine``, ``paged=False`` engine, batch-1
    ``OffloadEngine`` — must each give identical streams, routed ids and
    ``EngineStats`` on the card and on the CPU, and identical streams to
    each other."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import OffloadEngine
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    cuts = dict(num_layers=2, block_pattern=("chunked", "global"), chunk=16,
                dtype="float32")
    cfg = get_config("llama4-scout-17b-a16e").replace(**cuts)
    model = build_model(cfg)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    params = model.init(gen, device="cpu")          # drawn on the card
    pc = predictor_config(PredictorConfig, cfg)
    pp_gpu, pp_cpu = predictor_pair(torch, dev, pc, SEED + 6)
    rng = np.random.default_rng(SEED + 7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (30, 9)]
    max_new, cache_len, capacity, layer_s = 8, 48, 4, 2e-4
    runs = {}
    for where, pp in (("card", pp_gpu), ("cpu", pp_cpu)):
        device = dev if where == "card" else "cpu"
        for engine in ("paged", "rows", "batch1"):
            t0 = time.perf_counter()
            if engine == "batch1":
                eng = OffloadEngine(model, params,
                                    OnlineMoEBeyondPolicy(pp, pc), capacity,
                                    host_bw=PARITY_HOST_BW,
                                    layer_compute_s=layer_s, device=device)
            else:
                serve = ServeConfig(max_batch=2, block_size=8,
                                    paged=engine == "paged",
                                    layer_compute_s=layer_s)
                eng = BatchedOffloadEngine(
                    model, params, lambda pp=pp: OnlineMoEBeyondPolicy(pp, pc),
                    capacity, serve=serve, host_bw=PARITY_HOST_BW,
                    device=device)
            routes = record_routes(eng.core, check_finite=True)
            if engine == "batch1":
                outs = [eng.generate(p, max_new, cache_len) for p in prompts]
            else:
                outs = eng.generate(prompts, max_new, cache_len)
                if engine == "paged":
                    eng.pool.check_leaks(expected_in_use=0)
            st = eng.stats.as_dict()
            st.pop("latency")
            runs[(where, engine)] = (outs, routes, st)
            log(f"parity run 2: {engine} engine on the {where} in "
                f"{time.perf_counter() - t0:.1f} s")
            del eng
    for engine in ("paged", "rows", "batch1"):
        check_same(f"parity run 2, {engine}: ", runs[("card", engine)],
                   runs[("cpu", engine)])
    streams = {e: runs[("card", e)][0] for e in ("paged", "rows", "batch1")}
    if not streams["paged"] == streams["rows"] == streams["batch1"]:
        fail(f"parity run 2: the three engines' streams differ: {streams}")
    return {"config": cfg.name, "cuts": {**cuts, "block_pattern":
                                         list(cuts["block_pattern"])},
            "prompt_lens": [len(p) for p in prompts], "max_new": max_new,
            "cache_len": cache_len, "capacity_slots": capacity,
            "streams": streams["paged"],
            "stats": {e: runs[("card", e)][2]
                      for e in ("paged", "rows", "batch1")},
            "identical": True}


# main run 3 parts: (name, requests, prompt length, greedy decode steps)
MAMBA_PARTS = (("batch", 4, 4000, 64), ("long", 1, 32768, 16))


def tensors(tree) -> list:
    """The tensors of a nested dict/list parameter or state tree."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for v in tree for t in tensors(v)]
    return [tree]


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def greedy(torch, model, params, prompts, steps: int):
    """Facade prefill, then ``steps`` greedy decode steps on the prompts'
    device, nothing read back to the host until the end. Returns (streams
    (B, steps) as lists, last-position logits of the prefill and of every
    step (steps + 1, B, V), final state, prefill seconds, decode
    seconds)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, state = model.prefill(params, {"tokens": prompts},
                                  prompts.shape[1] + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    toks, outs = [], [logits]
    t = time.perf_counter()
    for _ in range(steps):
        tok = logits.argmax(-1)
        toks.append(tok)
        logits, state = model.decode_step(params, state,
                                          {"tokens": tok[:, None]})
        outs.append(logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    return (torch.stack(toks).T.tolist(), torch.stack(outs), state,
            prefill_s, decode_s)


def mamba_run(torch, np, dev):
    """Main run 3: mamba2-130m at full width and depth, bfloat16, seeded
    random weights, through the facade; prefill and decode timed apart,
    launches counted over each part. Each part runs once untimed at its
    own shapes first (prefill and 2 steps), so first-call library set-up
    (cuBLAS heuristics for new shapes) is not in its times or counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model

    cfg = get_config("mamba2-130m")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED + 8),
                        device=dev)
    torch.cuda.synchronize()
    result = {"config": cfg.name, "dtype": cfg.dtype,
              "layers": cfg.num_layers, "chunk": cfg.ssm.chunk,
              "init_s": time.perf_counter() - t0,
              "param_bytes": sum(t.numel() * t.element_size()
                                 for t in tensors(params))}
    rng = np.random.default_rng(SEED + 8)
    total = {}
    for name, batch, prompt_len, steps in MAMBA_PARTS:
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, prompt_len))).to(dev)
        greedy(torch, model, params, prompts, 2)     # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        streams, outs, state, prefill_s, decode_s = greedy(
            torch, model, params, prompts, steps)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if tuple(outs.shape) != (steps + 1, batch, cfg.vocab_size):
            fail(f"main run 3 ({name}): logits of shape {tuple(outs.shape)}")
        if not torch.isfinite(outs).all():
            fail(f"main run 3 ({name}): non-finite logits")
        if state["pos"] != prompt_len + steps:
            fail(f"main run 3 ({name}): state at {state['pos']}")
        want = {k: 0 for k in launches}
        want["ssd_chunk"] = cfg.num_layers
        if launches != want:
            fail(f"main run 3 ({name}): launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        result[name] = {
            "requests": batch, "prompt_len": prompt_len,
            "chunks_per_request": -(-prompt_len // cfg.ssm.chunk),
            "decode_steps": steps, "prefill_s": prefill_s,
            "prefill_tokens_per_s": batch * prompt_len / prefill_s,
            "decode_s": decode_s,
            "decode_tokens_per_s": batch * steps / decode_s,
            "decode_ms_per_step": decode_s / steps * 1e3,
            "max_memory_allocated_bytes": peak,
            "launches": launches, "stream_head": [s[:8] for s in streams]}
        del outs, state
    result["launches"] = total
    del params
    return result, total


def parity_run_mamba(torch, np, dev):
    """Parity run 3: mamba2-130m at full width in float32, 4 layers, 2
    prompts of 300 tokens (padded to 3 chunks), 16 greedy steps through the
    facade on the card and on the CPU from identical weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    layers, prompt_len, steps, tol = 4, 300, 16, 1e-3
    cfg = get_config("mamba2-130m").replace(num_layers=layers,
                                            dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 9),
                        device="cpu")                 # drawn on the card
    prompts = torch.from_numpy(np.random.default_rng(SEED + 9).integers(
        0, cfg.vocab_size, (2, prompt_len)))
    runs = {}
    for where, p, d in (("card", to_device(params, dev), dev),
                        ("cpu", params, torch.device("cpu"))):
        streams, outs, _, _, _ = greedy(torch, model, p, prompts.to(d),
                                        steps)
        if not torch.isfinite(outs).all():
            fail(f"parity run 3: non-finite logits on the {where}")
        runs[where] = (streams, outs.cpu())
    if runs["card"][0] != runs["cpu"][0]:
        fail(f"parity run 3: GPU/CPU streams differ: {runs['card'][0]} vs "
             f"{runs['cpu'][0]}")
    err = (runs["card"][1] - runs["cpu"][1]).abs().max().item()
    if not err <= tol:
        fail(f"parity run 3: last-position logits differ by {err} > {tol}")
    return {"config": cfg.name, "layers": layers, "dtype": "float32",
            "prompt_len": prompt_len, "requests": 2, "decode_steps": steps,
            "streams": runs["card"][0], "max_abs_logit_err": err,
            "tolerance": tol,
            "logit_abs_max": runs["cpu"][1].abs().max().item(),
            "identical_streams": True}


# (name, source, the TPU kernel it replaces, the main run whose launches
# the kernels line reports, the dtype of that run's calls)
LLAMA4, MAMBA2 = "llama4-scout-17b-a16e", "mamba2-130m"
KERNELS = [
    ("paged_flash_decode", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:106", LLAMA4, "bfloat16"),
    ("flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
     "src/repro/kernels/flash_attention.py:58", LLAMA4, "bfloat16"),
    ("expert_ffn", "src/repro_torch/kernels/csrc/expert_ffn.cu",
     "src/repro/kernels/expert_ffn.py:39", LLAMA4, "bfloat16"),
    ("topk_gating", "src/repro_torch/kernels/csrc/topk_gating.cu",
     "src/repro/kernels/topk_gating.py:52", LLAMA4, "float32"),
    ("ssd_chunk", "src/repro_torch/kernels/csrc/ssd_chunk.cu",
     "src/repro/kernels/ssd_chunk.py:41", MAMBA2, "float32"),
]
TIMING_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "eager_ms", "plain_eager_ms", "library_eager_ms", "shape")


def timing_fields(c) -> dict:
    """A shape's timings for the kernels line (``floor_ratio`` where the
    check gives one)."""
    return {**{k: c[k] for k in TIMING_KEYS},
            **{k: c[k] for k in ("floor_ratio",) if k in c}}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import build

    # float32 means float32: no TF32 in matmuls (the default) or in cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    ident = gpu_identity()
    log(f"kernels built in {build_s:.1f} s on {ident}")

    gen = torch.Generator(dev).manual_seed(SEED)
    phase_s = {}
    t = time.perf_counter()
    floor_ms = launch_floor_ms(torch, dev)
    checks = {"paged_flash_decode": check_paged(torch, F, dev, gen),
              "expert_ffn": check_expert(torch, dev, gen),
              "topk_gating": check_topk(torch, dev, gen, floor_ms),
              "flash_decode": check_flash(torch, F, dev, gen),
              "ssd_chunk": check_ssd(torch, dev, gen)}
    phase_s["kernel_checks"] = time.perf_counter() - t
    release_host_memory(torch)
    log(f"kernel checks passed in {phase_s['kernel_checks']:.1f} s")

    # the main runs' modeled fetches at this card's host-to-device rate:
    # pinned copies of one DeepSeek-V2-Lite expert, measured once
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import expert_bytes, measured_host_bw
    host_bw = measured_host_bw(dev, expert_bytes(
        get_config("deepseek-v2-lite")))
    log(f"host to device: {host_bw / 1e9:.2f} GB/s (main runs 1 and 2)")

    # what a phase builds for a later one (the pipelines' backbones and
    # predictors), taken by the phase that uses it, then freed
    runs, launches, keep = {}, {}, {}
    allocated = {"kernel_checks": torch.cuda.memory_allocated()}
    ds = "deepseek-v2-lite"
    # (phase, arch, run, the key of its launches in ``launches`` or None)
    phases = (
        ("main_run", ds, lambda: main_run(torch, np, dev, ds, host_bw), ds),
        ("parity_run", ds, lambda: parity_run(torch, np, dev), None),
        ("pipeline", ds, lambda: pipeline_run(torch, np, dev, keep),
         "pipeline"),
        ("main_run_trained", ds,
         lambda: main_run_trained(torch, np, dev, host_bw,
                                  keep.pop("pipeline"),
                                  (runs["main_run"], launches[ds])),
         "main_run_trained"),
        ("parity_pipeline", ds, lambda: parity_run_pipeline(torch, np, dev),
         None),
        ("train", ds, lambda: train_run(torch, np, dev), "train"),
        ("parity_train", ds, lambda: parity_run_train(torch, np, dev), None),
        ("pipeline_trained", ds,
         lambda: pipeline_trained_run(torch, np, dev,
                                      runs["pipeline"]["policies"], keep),
         "pipeline_trained"),
        ("serve_trained", ds,
         lambda: serve_trained_run(torch, np, dev,
                                   keep.pop("pipeline_trained")),
         "serve_trained"),
        ("main_run_2", LLAMA4,
         lambda: main_run(torch, np, dev, LLAMA4, host_bw), LLAMA4),
        ("parity_run_2", LLAMA4, lambda: parity_run_llama4(torch, np, dev),
         None),
        ("main_run_3", MAMBA2, lambda: mamba_run(torch, np, dev), MAMBA2),
        ("parity_run_3", MAMBA2, lambda: parity_run_mamba(torch, np, dev),
         None))
    for phase, arch, run, key in phases:
        t = time.perf_counter()
        if key is None:
            runs[phase] = run()
        else:
            runs[phase], launches[key] = run()
        phase_s[phase] = time.perf_counter() - t
        release_host_memory(torch)
        # device bytes still allocated once the phase's tensors are freed:
        # what every later phase's peak memory includes
        allocated[phase] = torch.cuda.memory_allocated()
        log(f"{phase} ({arch}) done in {phase_s[phase]:.1f} s")

    kernels = []
    for name, source, replaces, run, dtype in KERNELS:
        c = checks[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[run][name],
            "launches_run": run,
            "launches_by_run": {a: n[name] for a, n in launches.items()},
            "max_abs_err": c[dtype], "max_abs_err_dtype": dtype,
            "max_abs_err_f32": c["float32"],
            "max_abs_err_bf16": c.get("bfloat16"), "kernel_ms": c["ms"],
            **timing_fields(c)}
        extra = c.get("gqa") or c.get("llama4")
        if extra is not None:   # the same kernel at main run 2's shapes
            entry["main_run_2_shapes"] = {
                "max_abs_err": extra.get("bfloat16", extra["float32"]),
                "max_abs_err_f32": extra["float32"], **timing_fields(extra)}
        if "prefill" in c:      # main run 1's prefill-chunk shape
            pre = c["prefill"]
            entry[("mla_" if name == "paged_flash_decode" else "")
                  + "prefill_chunk_shape"] = {
                "max_abs_err": pre.get("bfloat16", pre["float32"]),
                "max_abs_err_f32": pre["float32"], **timing_fields(pre)}
        if "pipeline" in c:     # the pipeline's batch-1 trace decode
            pipe = c["pipeline"]
            entry["pipeline_shape"] = {
                "max_abs_err": pipe.get("bfloat16", pipe["float32"]),
                "max_abs_err_f32": pipe["float32"], **timing_fields(pipe)}
        if "pipeline_trained" in c:   # the trained pipeline's trace decode
            pt = c["pipeline_trained"]
            entry["pipeline_trained_shape"] = {
                "max_abs_err": pt["float32"], **timing_fields(pt)}
        if "train" in c:        # the training forward's router
            entry["training_shapes"] = {
                shape: {"max_abs_err": c[shape]["float32"],
                        **timing_fields(c[shape])}
                for shape in ("train", "train_100m")}
        serve = {shape: {"max_abs_err": case["float32"],
                         **timing_fields(case)}
                 for shape, case in c.items() if shape.startswith("serve_")}
        if serve:               # serve_trained's engines on the 53.5 M backbone
            entry["serve_trained_shapes"] = serve
        for shape in ("long", "reduced"):   # ssd_chunk's other shapes
            if shape in c:
                entry[f"{shape}_shape_max_abs_err"] = c[shape]
        kernels.append(entry)
    report = {"gpu": ident, "build_s": build_s, "phase_s": phase_s,
              "allocated_bytes_after_phase": allocated,
              "launch_floor_ms": floor_ms,
              "kernels": kernels, "checks": checks, **runs,
              "ptxas": [ln for ln in build.BUILD_LOG.splitlines()
                        if "ptxas info" in ln]}
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"phase_s": {"build": build_s, **phase_s},
                      "allocated_bytes_after_phase": allocated}), flush=True)
    print(json.dumps({k: runs[k] for k in ("main_run", "main_run_2",
                                           "main_run_3")}), flush=True)
    print(json.dumps({"parity_run_3": {k: runs["parity_run_3"][k] for k in (
        "max_abs_logit_err", "tolerance", "identical_streams")}}),
        flush=True)
    pipe = runs["pipeline"]
    print(json.dumps({"pipeline": {k: pipe[k] for k in (
        "decode_steps", "trace_s", "trace_steps_per_s", "trace_launches",
        "train_s", "train_steps", "epochs", "last_epoch", "untrained_val",
        "trained_val", "host_bw_bytes_per_s", "capacity_slots", "policies",
        "max_memory_allocated_bytes")}, "seconds": phase_s["pipeline"]}),
        flush=True)
    print(json.dumps({"parity_pipeline": {k: runs["parity_pipeline"][k]
                                          for k in (
        "identical_traces", "max_abs_logit_err", "tolerance",
        "identical_tables")}}), flush=True)
    print(json.dumps({"host_bw_bytes_per_s": host_bw, "sim_stall_s": {
        k: runs[k]["sim_stall_s"] for k in ("main_run", "main_run_2")}}),
        flush=True)
    tr = runs["train"]
    print(json.dumps({"train": {k: tr[k] for k in (
        "layers", "params", "batch", "seq", "steps", "losses",
        "median_s_per_step_after_first", "median_tokens_per_s_after_first",
        "max_memory_allocated_bytes", "warmup_launches", "launches")},
        "s_per_step": [st["s"] for st in tr["steps_detail"]],
        "seconds": phase_s["train"]}), flush=True)
    print(json.dumps({"parity_train": runs["parity_train"]}), flush=True)
    pt = runs["pipeline_trained"]
    print(json.dumps({"pipeline_trained": {k: pt[k] for k in (
        "params", "loss_curve", "backbone_s", "backbone_launches",
        "decode_steps", "trace_s",
        "trace_steps_per_s", "trace_launches", "train_s", "last_epoch",
        "untrained_val", "trained_val", "shape_holds",
        "random_backbone_10%")},
        "hit_rates": {frac: {k: [v["cache_hit_rate"], v["std_error"],
                                 v["prediction_hit_rate"]]
                             for k, v in row["policies"].items()}
                      for frac, row in pt["caches"].items()},
        "seconds": phase_s["pipeline_trained"]}), flush=True)
    mt = runs["main_run_trained"]
    print(json.dumps({"main_run_trained": {k: mt[k] for k in (
        "predictor", "predictor_max_seq",
        "same_streams_routes_launches_as_main_run", "main_run",
        *MAIN_RUN_COUNTERS)}, "seconds": phase_s["main_run_trained"]}),
        flush=True)
    st = runs["serve_trained"]
    print(json.dumps({"serve_trained": {
        "host_bw_bytes_per_s": st["host_bw_bytes_per_s"],
        "ranking": st["ranking"],
        "runs": [{k: r[k] for k in (
            "engine", "cache", "policy", "requests", "capacity_slots",
            "hit_rate", "sim_cache_hit_rate", "sim_std_error",
            "sim_cache_hit_rate_all", "prefetch_hit_share",
            "fetch_mib", "sim_stall_s", "blocking_stall_s", "overlapped_s",
            "run_s", "generated_tokens_per_s")} for r in st["runs"]]},
        "seconds": phase_s["serve_trained"]}), flush=True)
    print(json.dumps({"launch_floor_ms": floor_ms}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ident, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
