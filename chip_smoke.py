#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Usage, from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the three CUDA kernels from ``src/repro_torch/kernels/csrc`` and
   identify the card;
2. hold each kernel against its plain PyTorch version at the main path's
   full-width shapes, in bfloat16 and float32, and time kernel, plain
   version and a PyTorch library yardstick with CUDA events: ``ms`` is
   device time (calls replayed from a CUDA graph), ``eager_ms`` the time
   per eager call, Python and launch overhead included;
3. main run: full-width DeepSeek-V2-Lite in bfloat16 (seeded random
   weights, routed experts in pinned host memory) served by
   ``BatchedOffloadEngine`` with the paper's learned prefetch policy at a
   10% expert cache, counting every kernel launch;
4. on-card parity: full width, float32, depth cut to 3 layers; the engine
   on the card and on the CPU from identical weights must give identical
   streams, routed expert ids and counters.

The last stdout line is ``{"ok": true, "device": {...}}``; the line
before it is the card's name and power limit; before that the
``{"kernels": [...]}`` line. Details go to ``chiprun_out/chip_smoke.json``.
This script imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import gc
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

def check_paged(torch, F, dev, gen):
    from repro_torch.kernels import paged_attention as pa
    n, g, dk, dv, bs, w = 4, 16, 576, 512, 8, 16    # decode, cache_len 128
    scale = 192 ** -0.5
    pos_list = [95, 90, 84, 71]                      # 64 prompt + decode
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q = torch.randn(n, 1, g, dk, generator=gen, device=dev).to(dt)
        pool = torch.randn(n * w + 1, bs, 1, dk, generator=gen,
                           device=dev).to(dt)
        tables = (1 + torch.randperm(n * w, generator=gen, device=dev)
                  ).to(torch.int32).reshape(n, w)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        args = (q, pool, None, tables, pos)
        o = pa.paged_flash_decode(*args, scale=scale, dv=dv)
        op = pa.paged_flash_decode_plain(*args, scale=scale, dv=dv)
        torch.cuda.synchronize()
        err = (o.float() - op.float()).abs().max().item()
        tol = 1e-4 if dtype == "float32" else 3e-2
        if not err <= tol:
            fail(f"paged_flash_decode {dtype}: max abs err {err} > {tol}")
        out[dtype] = err
        if dtype != "bfloat16":
            continue
        kpos = torch.arange(w * bs, device=dev)
        mask = (kpos[None, :] <= pos[:, None].long())[:, None, None, :]

        def library():   # gather the pages, then one dense attention call
            k = pool[tables.reshape(-1).long()].reshape(n, 1, w * bs, dk)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2).reshape(n, g, 1, dk),
                k.expand(n, g, w * bs, dk),
                k[..., :dv].expand(n, g, w * bs, dv), attn_mask=mask,
                scale=scale)
        out.update(timings(
            torch, lambda: pa.paged_flash_decode(*args, scale=scale, dv=dv),
            lambda: pa.paged_flash_decode_plain(*args, scale=scale, dv=dv),
            library))
        keys = sum(p + 1 for p in pos_list)
        pages = sum(p // bs + 1 for p in pos_list)
        el = 2
        nbytes = (pages * bs * dk * el + q.numel() * el + n * g * dv * el
                  + tables.numel() * 4 + n * 4)
        ops = keys * g * (2 * dk + 2 * dv)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        out.update(bound_ms=b_ms, bound_by=b_by,
                   shape=f"q ({n},1,{g},{dk}) bf16, pool "
                         f"({n * w + 1},{bs},1,{dk}), tables ({n},{w}), "
                         f"pos {pos_list}, dv {dv}")
    return out


def check_expert(torch, dev, gen):
    from repro_torch.kernels import expert_ffn as ef
    n, k, d, f, slots = 4, 6, 2048, 1408, 166
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        bufs = [(torch.randn(slots, *shape, generator=gen, device=dev)
                 * 0.02).to(dt) for shape in ((d, f), (d, f), (f, d))]
        x = torch.randn(n, d, generator=gen, device=dev).to(dt)
        w = torch.rand(n, k, generator=gen, device=dev).to(dt)
        sl = torch.randperm(slots, generator=gen, device=dev)[: n * k] \
            .to(torch.int32).reshape(n, k)
        y = ef.expert_ffn(x, w, sl, *bufs)
        yp = ef.expert_ffn_plain(x, w, sl, *bufs)
        torch.cuda.synchronize()
        err = (y.float() - yp.float()).abs().max().item()
        scale = max(1.0, yp.float().abs().max().item())
        tol = (1e-4 if dtype == "float32" else 2e-2) * scale
        if not err <= tol:
            fail(f"expert_ffn {dtype}: max abs err {err} > {tol}")
        out[dtype] = err
        if dtype == "bfloat16":
            out.update(timings(
                torch, lambda: ef.expert_ffn(x, w, sl, *bufs),
                lambda: ef.expert_ffn_plain(x, w, sl, *bufs)))
            distinct = len(set(sl.reshape(-1).tolist()))
            nbytes = distinct * 3 * d * f * 2 + 2 * n * d * 2 + n * k * 6
            ops = n * k * 6 * d * f
            out["bound_ms"], out["bound_by"] = bound(nbytes, ops, "bfloat16")
            out["shape"] = (f"x ({n},{d}) bf16, k {k}, slot buffers "
                            f"({slots},{d},{f})/({slots},{f},{d}), "
                            f"{distinct} distinct slots")
        del bufs
    return out


def check_topk(torch, dev, gen):
    from repro_torch.kernels import topk_gating as tg
    t, e, k = 4, 64, 6
    logits = torch.randn(t, e, generator=gen, device=dev) * 2
    logits[0, 7] = logits[0, 40] = logits[0].max() + 1.0     # exact tie
    w, idx = tg.topk_gating(logits, k)
    wp, ip = tg.topk_gating_plain(logits, k)
    torch.cuda.synchronize()
    if not torch.equal(idx, ip):
        fail(f"topk_gating ids differ from the plain version:\n{idx}\n{ip}")
    err = (w - wp).abs().max().item()
    if not err <= 1e-6:
        fail(f"topk_gating weights: max abs err {err} > 1e-6")

    def library():
        pw, pi = torch.topk(torch.softmax(logits, -1), k)
        return pw / (pw.sum(-1, keepdim=True) + 1e-9), pi
    b_ms, b_by = bound(t * e * 4 + t * k * 8, t * e * (4 + k), "float32")
    return {"float32": err, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"logits ({t},{e}) f32, k {k}",
            **timings(torch, lambda: tg.topk_gating(logits, k),
                      lambda: tg.topk_gating_plain(logits, k), library)}


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine

def record_routes(core, check_finite: bool = False):
    """Wrap a DecodeCore so each step/chunk logs its routed expert ids."""
    import numpy as np
    log_ = []
    step, chunk = core.step, core.prefill_chunk

    def rec_step(*a, **kw):
        out = step(*a, **kw)
        if check_finite and not np.isfinite(out[0]).all():
            fail("non-finite logits in a decode step")
        log_.append([[sorted(int(e) for e in g) for g in r] for r in out[2]])
        return out

    def rec_chunk(*a, **kw):
        out = chunk(*a, **kw)
        if check_finite and not np.isfinite(out[0]).all():
            fail("non-finite logits in a prefill chunk")
        log_.append([[sorted(int(e) for e in g) for g in r] for r in out[2]])
        return out

    core.step, core.prefill_chunk = rec_step, rec_chunk
    return log_


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


def main_run(torch, np, dev):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.core.predictor import predictor_init
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    cfg = get_config("deepseek-v2-lite")
    full_depth = cfg.num_layers
    m = cfg.moe
    per_layer = m.num_experts * 3 * cfg.d_model * m.d_ff_expert * 2
    avail = host_available_bytes()
    n_layers = cfg.num_layers
    # routed experts live in pinned host memory: cut depth (never widths)
    # only if they would not fit beside a 16 GB margin
    fit = int((avail - 16e9) // per_layer) + m.first_dense_layers
    if fit < n_layers:
        n_layers = max(m.first_dense_layers + 2, fit)
        log(f"depth cut to {n_layers} layers: {avail / 1e9:.1f} GB host "
            "memory available")
        cfg = cfg.replace(num_layers=n_layers)
    n_moe = n_layers - m.first_dense_layers
    capacity = max(int(0.10 * n_moe * m.num_experts), 4 * m.top_k)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED)
    model = build_model(cfg)
    params = model.init(gen, device=dev, expert_device="cpu")
    pc = predictor_config(PredictorConfig, cfg)
    pp = predictor_init(torch.Generator(dev).manual_seed(SEED + 1), pc,
                        device=dev)
    eng = BatchedOffloadEngine(
        model, params, lambda: OnlineMoEBeyondPolicy(pp, pc), capacity,
        max_batch=4, block_size=8, prefill_chunk=8, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, 64).tolist()
               for _ in range(4)]
    max_new, cache_len = 32, 128
    record_routes(eng.core, check_finite=True)
    reset_launch_counts()
    t1 = time.perf_counter()
    outs = eng.generate(prompts, max_new, cache_len)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = launch_counts()
    for name, count in launches.items():
        if count == 0:
            fail(f"main run never launched the {name} kernel")
    for s in outs:
        if len(s) != max_new + 1 or not all(0 <= x < cfg.vocab_size
                                            for x in s):
            fail(f"bad stream from the main run: {s}")
    st = eng.stats
    generated = sum(len(s) for s in outs)
    result = {
        "config": cfg.name, "dtype": cfg.dtype, "layers": n_layers,
        "depth_cut": n_layers != full_depth, "requests": len(prompts),
        "prompt_len": 64, "max_new": max_new, "cache_len": cache_len,
        "max_batch": 4, "block_size": 8, "prefill_chunk": 8,
        "capacity_slots": capacity, "policy": "moe-beyond-online",
        "init_s": init_s, "run_s": run_s,
        "generated_tokens": generated,
        "generated_tokens_per_s": generated / run_s,
        "positions_per_s": st.tokens / run_s,
        "hit_rate": st.hit_rate, "hits": st.hits, "misses": st.misses,
        "fetch_bytes": st.fetch_bytes, "steps": st.steps,
        "prefill_chunks": st.prefill_chunks,
        "prefill_tokens": st.prefill_tokens,
        "sim_stall_s": st.sim_stall_s, "launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    del eng, params, pp
    return result, launches


def parity_run(torch, np, dev):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.core.predictor import predictor_init
    from repro_torch.models.model import build_model
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    cfg = get_config("deepseek-v2-lite").replace(num_layers=3,
                                                 dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    params = model.init(gen, device="cpu")          # drawn on the card
    pc = predictor_config(PredictorConfig, cfg)
    pp_cpu = predictor_init(torch.Generator(dev).manual_seed(SEED + 3), pc,
                            device="cpu")
    pp_gpu = {k: ([{kk: vv.to(dev) for kk, vv in lp.items()} for lp in v]
                  if k == "enc" else v.to(dev)) for k, v in pp_cpu.items()}
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (11, 6)]
    runs = {}
    for where, pp in (("card", pp_gpu), ("cpu", pp_cpu)):
        eng = BatchedOffloadEngine(
            model, params, lambda pp=pp: OnlineMoEBeyondPolicy(pp, pc), 24,
            max_batch=2, block_size=8, prefill_chunk=8,
            layer_compute_s=2e-4, device=dev if where == "card" else "cpu")
        routes = record_routes(eng.core, check_finite=True)
        outs = eng.generate(prompts, 6, 32)
        eng.pool.check_leaks(expected_in_use=0)
        st = eng.stats.as_dict()
        st.pop("latency")
        runs[where] = (outs, routes, st)
        del eng
    if runs["card"][0] != runs["cpu"][0]:
        fail(f"GPU/CPU streams differ: {runs['card'][0]} vs "
             f"{runs['cpu'][0]}")
    if runs["card"][1] != runs["cpu"][1]:
        fail("GPU/CPU routed expert ids differ")
    if runs["card"][2] != runs["cpu"][2]:
        fail(f"GPU/CPU EngineStats differ: {runs['card'][2]} vs "
             f"{runs['cpu'][2]}")
    return {"layers": 3, "dtype": "float32", "streams": runs["card"][0],
            "routing_steps": len(runs["card"][1]),
            "stats": runs["card"][2], "identical": True}


KERNELS = [
    ("paged_flash_decode", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:106"),
    ("expert_ffn", "src/repro_torch/kernels/csrc/expert_ffn.cu",
     "src/repro/kernels/expert_ffn.py:39"),
    ("topk_gating", "src/repro_torch/kernels/csrc/topk_gating.cu",
     "src/repro/kernels/topk_gating.py:52"),
]


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

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    ident = gpu_identity()
    log(f"kernels built in {build_s:.1f} s on {ident}")

    gen = torch.Generator(dev).manual_seed(SEED)
    checks = {"paged_flash_decode": check_paged(torch, F, dev, gen),
              "expert_ffn": check_expert(torch, dev, gen),
              "topk_gating": check_topk(torch, dev, gen)}
    gc.collect()
    torch.cuda.empty_cache()
    log("kernel checks passed")

    t1 = time.perf_counter()
    main_res, launches = main_run(torch, np, dev)
    log(f"main run done in {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    parity = parity_run(torch, np, dev)
    log(f"parity run done in {time.perf_counter() - t2:.1f} s")

    kernels = []
    for name, source, replaces in KERNELS:
        c = checks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c.get("bfloat16", c.get("float32")),
            "max_abs_err_f32": c["float32"],
            "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "eager_ms": c["eager_ms"],
            "plain_eager_ms": c["plain_eager_ms"],
            "library_eager_ms": c["library_eager_ms"],
            "shape": c["shape"]})
    report = {"gpu": ident, "build_s": build_s, "kernels": kernels,
              "main_run": main_res, "parity": parity,
              "ptxas": [ln for ln in build.BUILD_LOG.splitlines()
                        if "ptxas info" in ln]}
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"main_run": main_res}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ident, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
