#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Usage, from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

0. refuse ``python -O`` (it strips the ledger checks' asserts), then
   enter one ``repro_torch.analysis.RetraceGuard`` for the whole process;
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
   top-2); the three serving kernels at serve_trained's float32
   shapes on the 53.5 M backbone; and ``paged_flash_decode`` at the
   prefix cache's shape, a chunk starting mid-block beside decode lanes
   whose tables share its first blocks; and the three serving kernels at
   main_run_236b's decode and prefill-chunk shapes: 128 heads over the
   576-wide latent page, D 5120 / F 1536 on 48 slots, 160 experts top-6;
   and the GQA slice's: ``flash_decode`` on facade_gemma3's full
   1,024-slot local ring (32 heads over 16 kv heads) and at phi3-mini's
   head width 96, ``paged_flash_decode``'s GQA layout on an 8-token
   prefill chunk of Llama-4-Scout's global layer, its lanes sharing one
   table; and ``flash_decode`` at recurrentgemma-9b's full 2,048-slot
   local ring, 16 heads over one kv head at hd 256, and at seamless's
   decode cross-attention over 512 frames; and ``expert_ffn`` at the
   dispatch phase's per-shard call, 48 tokens at k 1 on 16 experts),
   on rows with a tie across the
   k-th place, all values
   equal, and probabilities underflowed to 0; for all five, two calls on
   the same inputs must be bit-identical), in bfloat16 and float32 (the
   router in float32 only), and time kernel, plain version and a PyTorch
   library yardstick with CUDA events: ``ms`` is device time (calls
   replayed from a CUDA graph), ``eager_ms`` the time per eager call,
   Python and launch overhead included; ``launch_floor_ms`` is one trivial
   launch timed the same way, first, and ``topk_gating``'s
   ``floor_ratio`` is its ms over that floor; then the guard's
   ``self_check``: it must have seen the library load and phase 2's CUDA
   graph captures, and a trivial capture inside ``frozen("probe")`` must
   raise ``RetraceError``; every later phase runs inside
   ``guard.frozen(phase)`` (the ranks that ``dispatch`` and
   ``mesh_train`` spawn are other processes, unguarded);
3. main run: full-width DeepSeek-V2-Lite in bfloat16 (seeded random
   weights, routed experts in pinned host memory, 28.8 GB) served by
   ``BatchedOffloadEngine`` with the paper's learned prefetch policy at a
   10% expert cache, counting every kernel launch; its modeled fetches
   (and main run 2's) priced at this card's host-to-device rate, measured
   once before the phases (``measured_host_bw``, one expert's pinned
   copies);
3'. serve telemetry: main run 1 again on its backbone with
   ``ServeConfig.telemetry`` on; fails unless streams, routed ids,
   launches, hits, misses, fetch bytes, steps, prefill chunks and tokens
   and the modeled stall equal main run 1's, the telemetry's counters
   mirror ``EngineStats``, and ``tools/check_trace.py`` accepts its Chrome
   trace (``chiprun_out/serve_telemetry_trace.json``); reports its run
   time beside main run 1's, the trace's size and export time, the
   per-step and per-chunk wall profile, the predictor scoreboard and the
   stall instants by critical tier;
3a. parity workload: the prefix cache and preemption on the reduced
   DeepSeek-V2-Lite in float32, card against CPU, with the scheduler's
   clock replaced by ``workload.StepClock`` (one fake second per decode
   step or prefill chunk): 4 priority-1 requests sharing a 2-block prefix
   (one ending mid-block inside it) and 2 urgent arrivals that preempt;
   identical streams, routed ids, ``EngineStats``, ``PoolStats`` and
   ``PrefixStats``, and, with telemetry on at both sides, its
   deterministic content (``telemetry_content``);
3b. serve workload: main run 1's backbone (full width, bfloat16, its
   routed experts pinned once in place) cut to its first 4 of 27 layers
   (1 dense, 3 MoE, 24 slots: a 10% cache, floored at 4 x top-k) serving 8
   priority-1 requests that share a 64-token system prompt (32 new tokens
   each) and 2 priority-0 ones (8 new) arriving at 0.25 and 0.5 of a
   closed-loop run of the same requests, through ``run_workload`` with
   the prefix cache and preemption on at main run 1's 10% cache; fails
   unless it preempted, served >= 8 x 64 prompt positions from the index,
   cut ``prefill_tokens`` by exactly the hit tokens less the positions the
   preempted requests had processed, leaked no block and launched every
   kernel of the path; a ``LeakSanitizer`` on both runs' engines must
   sweep the pool at each of their 10 retires;
3c. parity tiers: the tiered expert store on the reduced DeepSeek-V2-Lite
   in float32, card against CPU: 4 shards on the consistent-hash ring, a
   disk spill, a tier-1 cache of 4, int8 cold tiers, auto fetch-vs-ship
   dispatch and learned replacement under the learned policy; identical
   streams, routed ids, ``EngineStats``, ``CacheStats``, ``StoreStats`` and
   int8 codes (the card quantizes on the card, the CPU on the CPU), and
   telemetry's deterministic content, with fetches from tiers 2 and 3 and
   ships;
3d. serve tiers: main run 1's backbone (its experts pinned once in place)
   behind the tiered store: 4 shards, 384 home experts a shard in memory
   and the rest (188 experts, 3.25 GB) in a spill file under ``build/``,
   a tier-1 cache of 166, main run 1's prompts, slots and predictor at a
   150 us layer clock: (b) the tiers' horizons, fetch, LRU; (c) auto
   dispatch with learned replacement; (d) (c) on int8 cold tiers ((a),
   one-layer horizons, is left out for time). (b) and (c) must give main
   run 1's stream and route digests; every run must fetch from disk, (b)
   from peers, (c)-(d) ship, and (d)'s cold fetches move the int8 size;
   (c) runs under a ``LeakSanitizer``, which must sweep the pool and the
   store's residency ledger at each of its 4 retires;
   the ``expert_ffn`` check of phase 2 includes the ship rows past the
   166 slots;
3e. main run 236B: DeepSeek-V2-236B at full width (128 heads, MLA with
   the compressed q projection, 160 routed experts top-6, 2 shared) cut
   to 4 of its 60 layers (1 dense, 3 MoE: 22.6 GB of routed experts in
   pinned host memory, ~38.7 GB once the pinned allocator rounds each
   tensor up to a power of two) in bfloat16, main run 1's setup (a 10%
   cache of 48 slots, the seeded learned policy, 4 requests of 32 new
   tokens), served three times on one backbone under the compute clocks
   ``layer_compute_s`` 0.0, ``"roofline"`` and ``"measured"`` (the
   card's bf16 peak and memory rate); fails unless streams, routed ids,
   launches, hits, misses and fetch bytes are equal across the clocks;
   reports each clock's times, modeled stall, mean roofline halves and
   calibration;
3f. parity 236B: the reduced DeepSeek-V2-236B in float32 through the
   paged engine under ``"roofline"``, card against CPU: identical
   streams, routed ids and every ``EngineStats`` field;
4. on-card parity: DeepSeek-V2-Lite at full width, float32, depth cut to 3
   layers; the engine on the card and on the CPU from identical weights
   must give identical streams, routed expert ids and counters;
4a. pipeline: the paper's pipeline on main run 1's backbone (full width
   and depth, bfloat16, the same seed), every routed expert on the device
   (~31 GB): 20 batch-1 traces of 64 prompt tokens from the topic corpus
   and 16 sampled ones (1,600 decode steps through the facade's decode
   mode, ``topk_gating`` and ``expert_ffn`` on every MoE layer), the
   paper's full-size predictor trained on 12 of them with
   ``train_predictor``'s defaults, and the other 8 replayed through the
   cache simulator at a 10% cache with all seven policies, each with its
   per-trace standard error; fails unless both kernels launched exactly
   once per MoE layer and step (26 x 1,600), every loss is finite, the
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
4d0. examples_cli: the port's four example command lines in this
   process through ``main(argv)`` with ``--device cuda``:
   ``collect_traces_torch`` (8 traces, 24 new tokens, 30 training
   steps), ``train_predictor_torch`` (3 epochs) on its file,
   ``train_backbone_torch`` (4 steps at B 8 x S 256, ``--save``) and
   ``serve_with_cache_torch`` (8 tokens); fails unless the trace file
   reads back with (T, MoE layers, k) experts in range, the predictor
   file (the reference's flat-npz layout) reads back bit for bit with
   the same logits on one batch, the backbone's checkpoint reloads bit
   for bit, each printed the reference CLI's lines, and ``topk_gating``
   and ``expert_ffn`` launched;
4d'. checkpoint: ``launch.train.train(save=)`` on DeepSeek-V2-Lite at
   full width in bfloat16, depth cut to 2 layers (1 dense, 1 MoE; 1.085 B
   parameters, a 4.34 GB float32 npz in a temporary directory whose free
   space is checked first), 2 AdamW steps at B 4 x S 1024, then
   ``checkpoint.load`` into a fresh ``model.init`` on the card; fails
   unless every leaf is restored bit for bit (value, dtype, shape,
   device), ``loss_fn`` on a held-out batch gives identical loss and
   metrics on both trees, and ``topk_gating`` launched exactly once per
   MoE layer and forward; reports the file's bytes, save and load times
   and rates and the peak resident set sampled during the phase;
4d''. dispatch: ``launch.sharding.expert_dispatch_ffn`` on 4 spawned
   ranks sharing the card (``gloo`` over ``file://`` rendezvous), each
   holding 16 of DeepSeek-V2-Lite's 64 experts at full width (D 2048,
   F 1408), at C 12 (48 received pairs, one ``expert_ffn`` call) and
   C 24 (two), ragged live counts with ``-1`` padding, in float32 and
   bfloat16 against ``expert_ffn_plain`` of every sent token on its
   global expert; fails if a rank raises, dies or outlasts its timeout,
   unless the errors are within phase 2's tolerance, padding is exact
   zeros and the launches are exact;
4d'''. mesh_train: ``launch.train.train(production_mesh=)`` on 4 spawned
   ranks sharing the card (``gloo`` over ``file://`` rendezvous) as a 2x2
   ``("data", "model")`` ``DeviceMesh``: every parameter and both AdamW
   moments sharded by the reference's rules, one unit (the embedding, a
   layer, the head) gathered at a time where the loss uses it and again
   for its backward pass, the routed experts expert-parallel, the MLA
   and GQA heads head-parallel and the embedding, head and loss
   vocabulary-parallel along ``"model"`` (each rank gathering only its
   ``"model"`` shard of them, partial outputs all-reduced over
   ``"model"``), 4 rows a data rank, each gradient reduce-scattered over
   ``"data"`` into the rank's slice;
   the reduced DeepSeek-V2-Lite in float32, then the checkpoint phase's
   model (full width, 2 layers, bfloat16) 2 steps at B 8 x S 1024, then
   the same two runs of internlm2-1.8b (GQA, untied head), against the
   same runs on one device, run first; fails if a rank raises, dies or
   outlasts its timeout, unless, for each model, the float32 losses and
   gathered parameters are within 1e-5 and the bfloat16 losses within
   2^-8 relative of the single-device ones, each rank holds the bytes
   its placements give, ``topk_gating`` launched once a MoE layer and
   step on each rank (none for internlm2), the routed ids of every MoE
   layer and step are the same on the two ``"model"`` ranks of each data
   rank, every step's gathered peak equals the largest unit as gathered
   (counted from the specs here), no gathered bytes are alive once
   ``train`` returned, ``model_reduced_bytes`` equals the count the
   shapes give, each rank computed with its vocabulary shard (and
   internlm2 with its query and KV head shards), and each rank's peak
   device memory is below the per-layer-gathering step's
   (DeepSeek-V2-Lite's below the step's that gathered the embedding and
   head whole); reports rank start, s a step, the bytes gathered,
   reduce-scattered and all-reduced over the data axes and over
   ``"model"`` a step, the gathered peak, peak memory a rank, for both
   models on one line;
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
5. main run 2: full-width Llama-4-Scout in bfloat16, depth cut to 4 layers
   (one 3:1 chunked:global group; 16.1 GB of routed experts in pinned
   host memory; 8 layers until main_run_236b needed the time), paged
   engine: global layers through the block pools
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
   shift-and-add, never a cuDNN convolution;
9. facade Scout: Llama-4-Scout at full width in bfloat16, 4 of 48 layers
   (one 3:1 chunked:global group, every expert on the card, ~21.8 GB),
   drop-free capacity: ``Model.prefill`` of 256 patches of width 1,408
   (the vision early-fusion prefix) and a 64-token prompt at B 2, 32
   greedy ``decode_step``s, then ``collect_trace`` of one 64-token prompt
   with 32 new tokens at batch 1; the prefill's last logits and the
   first 8 steps' against ``forward`` on the fused sequence (reported);
   fails on non-finite logits or launches off one ``flash_decode`` a
   layer and step and one ``expert_ffn``/``topk_gating`` a MoE layer and
   step (and the prefill's router);
10. facade gemma3: gemma3-27b at full width in bfloat16, 6 of 62 layers
   (one 5 local : 1 global group, ~7.8 GB): a 1,100-token prompt (the
   1,024-slot ring wraps) and 32 greedy steps, against ``forward``;
11. parity GQA: the reduced yi-6b, internlm2-1.8b, phi3-mini-3.8b,
   gemma3-27b, pixtral-12b and Llama-4-Scout (the last two with patches)
   in float32 through ``prefill`` and 8 greedy steps, Scout's greedy
   trace, and Scout cut to global layers through the paged engine's
   chunked prefill (``paged_attn_prefill``) with the prefix index off and
   on: card against CPU, identical streams, routed ids and
   ``EngineStats``, logits within 1e-4;
12. facade recurrentgemma: recurrentgemma-9b at full width in bfloat16,
   6 of 38 layers (two rglru, rglru, local groups; 2.36 B parameters):
   2 prompts of 2,100 tokens (the RG-LRU's log-depth scan; the
   2,048-slot local ring wraps) and 32 greedy steps, ``flash_decode``
   exactly once a local layer and step, against ``forward``;
13. facade seamless: seamless-m4t-large-v2 at full width and depth (24
   encoder and 24 decoder layers, 2.04 B parameters) in bfloat16: 512
   seeded audio frames and a 16-token prompt at B 2, 32 greedy steps,
   ``flash_decode`` exactly twice a decoder layer and step (self- and
   cross-attention), against ``forward``; the encoder timed alone;
14. parity recurrent: the reduced recurrentgemma-9b and
   seamless-m4t-large-v2 in float32 through ``prefill`` and 8 greedy
   steps, card (``flash_decode``) against CPU (its plain version):
   identical streams, logits within 1e-4.

Phases 3' and 3a-3f are named ``serve_telemetry``, ``parity_workload``,
``serve_workload``, ``parity_tiers``, ``serve_tiers``, ``main_run_236b``
and ``parity_236b`` in the output;
phases 4a-4f ``pipeline``, ``main_run_trained``, ``parity_pipeline``,
``train``, ``parity_train``, ``examples_cli``, ``checkpoint``, ``dispatch``,
``mesh_train``, ``pipeline_trained`` and ``serve_trained``;
phases 9-14 ``facade_scout``, ``facade_gemma3``, ``parity_gqa``,
``facade_recurrentgemma``, ``facade_seamless`` and ``parity_recurrent``.
Host memory:
about 26 GB for main run 2's pinned experts, ~38.7 GB for main run 236B's
(each main run's pinned blocks
are released before the next phase), 16 GB of float32 experts for parity
run 2, and in serve_tiers' run (d) up to ~10.8 GB of int8 peer copies
beside main run 1's pinned experts; the checkpoint phase's float32 copy
of its tree and the file's read buffer (~11 GB resident at its peak on
an H100 host). The last stdout line is ``{"ok": true,
"device": {...}}``; the line before it is the card's name and power limit;
before that the ``{"kernels": [...]}`` line, whose ``launches`` are the
counts of the main run that drives each kernel (Llama-4-Scout's for the
four attention and MoE kernels, mamba2's for ``ssd_chunk``;
``launches_by_run`` has every main run's, main_run_236b's and the
serve_telemetry, serve_workload, serve_tiers, pipeline, main_run_trained,
train, examples_cli, checkpoint, dispatch (its ranks' ``expert_ffn``
calls), mesh_train
(its ranks' ``topk_gating`` calls), pipeline_trained, serve_trained,
facade_scout, facade_gemma3,
facade_recurrentgemma and facade_seamless phases'), and
before that ``{"launch_floor_ms": ...}``, ``{"retrace_guard": ...}``
(the guard's events by source and program, the probe's message) and the
phases' summaries. Details go to
``chiprun_out/chip_smoke.json``.
This script imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import re
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
# global layers), serve_trained's batched runs on the trained 53.5 M
# backbone in float32 (cache_len 81, W 11): 8 heads over its 64 + 16 latent
# at decode and at a prefill chunk, 5 tokens (the 11-slot cache clamps the
# chunk to 11 // top-2 pairs), and the prefix cache's MLA shape: an 8-token
# chunk at positions 60-67 (it starts mid-block after a sub-block match)
# with 3 decode lanes whose tables share the chunk table's first 7 blocks,
# then main_run_236b's: DeepSeek-V2-236B's 128 heads over the same latent
# page at decode and at a prefill chunk. A shape with a ``seed`` draws its
# inputs from a generator of its own, so the shapes before it keep theirs
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
    "prefix_prefill": dict(kvh=1, g=16, dk=576, dv=512, gqa=False, qk=192,
                           pos_list=tuple(range(60, 68)) + (95, 90, 84),
                           shared_prefix=(8, 7), seed=SEED + 9),
    "v236_decode": dict(kvh=1, g=128, dk=576, dv=512, gqa=False, qk=192,
                        seed=SEED + 33),
    "v236_prefill": dict(kvh=1, g=128, dk=576, dv=512, gqa=False, qk=192,
                         pos_list=tuple(range(56, 64)), shared_table=True,
                         seed=SEED + 34),
    # paged_attn_prefill at Llama-4-Scout's width: a global layer's 8-token
    # prompt chunk, each token a lane on the request's one table
    "gqa_prefill": dict(kvh=8, g=5, dk=128, dv=128, gqa=True, qk=128,
                        pos_list=tuple(range(56, 64)), shared_table=True,
                        seed=SEED + 42),
}


def seeded(torch, dev, gen, shape: dict):
    """(generator, keywords) of a phase-2 shape: its own generator when it
    names a ``seed``, else the shared ``gen``."""
    kw = dict(shape)
    seed = kw.pop("seed", None)
    return (gen if seed is None
            else torch.Generator(dev).manual_seed(seed)), kw


def check_paged(torch, F, dev, gen):
    """``paged_flash_decode`` at every shape of ``PAGED_SHAPES``, the first
    at the top level."""
    from repro_torch.kernels import paged_attention as pa
    out = paged_case(torch, F, dev, gen, pa, **PAGED_SHAPES["mla"])
    for name in list(PAGED_SHAPES)[1:]:
        g, kw = seeded(torch, dev, gen, PAGED_SHAPES[name])
        out[name] = paged_case(torch, F, dev, g, pa, **kw)
    return out


def paged_inputs(torch, dev, gen, dt, kvh, g, dk, dv, gqa, qk,
                 pos_list=(95, 90, 84, 71), shared_table=False, w=16,
                 shared_prefix=None):
    """(args, keywords) of one call: decode lanes (prompt + decode
    positions) with a table of ``w`` blocks each, or the tokens of one
    prefill chunk as lanes sharing one table; with ``shared_prefix`` =
    (chunk lanes, blocks), the first lanes are one prefill chunk on one
    table and every other lane's table starts with that table's first
    blocks (a prefix adopted from the index); seeded random q and pools in
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
    if shared_prefix is not None:
        chunk, blocks = shared_prefix
        tables[:chunk] = tables[0]
        tables[chunk:, :blocks] = tables[0, :blocks]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    return (q, pool, v_pool, tables, pos), {"scale": qk ** -0.5, "dv": dv}


def paged_case(torch, F, dev, gen, pa, kvh, g, dk, dv, gqa, qk,
               pos_list=(95, 90, 84, 71), shared_table=False, w=16,
               timed="bfloat16", shared_prefix=None):
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
                                g, dk, dv, gqa, qk, pos_list, shared_table, w,
                                shared_prefix)
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
        if shared_prefix is not None:
            tabs = (f"tables, the first {shared_prefix[0]} lanes' one, its "
                    f"first {shared_prefix[1]} blocks in every table")
        short = "bf16" if dtype == "bfloat16" else "f32"
        out.update(bound_ms=b_ms, bound_by=b_by, bit_identical=True,
                   shape=f"q ({n},{kvh},{g},{dk}) {short}, {pools}, {tabs} "
                         f"({n},{w}), pos {pos_list}")
    return out


# flash_decode's shapes on main run 2 (Llama-4-Scout's chunked layers): 4
# lanes of 40 query heads over 8 kv heads, hd 128, valid_len up to 96 of
# a row of the chunked ring (S = 8192, the timed case) or of a global row
# (S = cache_len = 128); then the dense decoders' (FLASH_DENSE_SHAPES,
# each timed in bfloat16, its inputs from a generator of its own):
# facade_gemma3's decode on the full 1,024-slot local ring (1 lane, 32
# heads over 16 kv heads) and phi3-mini's head width 96 (32 heads, 32 kv
# heads, 4 lanes on rows of cache_len 128); then facade_recurrentgemma's
# decode on the full 2,048-slot local ring (2 lanes, 16 heads over one kv
# head at hd 256, the kernel's widest: two head groups) and
# facade_seamless's decode cross-attention over 512 frames (2 lanes, 16
# heads over 16 kv heads, hd 64; every key live)
FLASH_SHAPES = {"ring": dict(s_len=8192), "global": dict(s_len=128)}
FLASH_DENSE_SHAPES = {
    "gemma3_ring": dict(s_len=1024, vl_list=(1024,), n=1, h=32, kvh=16,
                        hd=128, rows=(1,), seed=SEED + 40),
    "phi3_hd96": dict(s_len=128, n=4, h=32, kvh=32, hd=96, seed=SEED + 41),
    "recurrentgemma_ring": dict(s_len=2048, vl_list=(2048, 2048), n=2, h=16,
                                kvh=1, hd=256, rows=(1, 0), seed=SEED + 60),
    "seamless_cross": dict(s_len=512, vl_list=(512, 512), n=2, h=16, kvh=16,
                           hd=64, rows=(0, 1), seed=SEED + 61),
}


def flash_inputs(torch, dev, gen, dt, s_len, vl_list=(96, 90, 84, 71), n=4,
                 h=40, kvh=8, hd=128, rows=(3, 0, 2, 1)):
    """(q, k_cache, v_cache, rows, valid_len) of one call: ``n`` lanes on
    ``rows`` of ``max(rows) + 2`` cache rows; seeded random q and caches
    in type ``dt``."""
    r = max(rows) + 2
    q = torch.randn(n, h, hd, generator=gen, device=dev).to(dt)
    kc = torch.randn(r, s_len, kvh, hd, generator=gen, device=dev).to(dt)
    vc = torch.randn(r, s_len, kvh, hd, generator=gen, device=dev).to(dt)
    rows = torch.tensor(rows, dtype=torch.int32, device=dev)
    vl = torch.tensor(vl_list, dtype=torch.int32, device=dev)
    return q, kc, vc, rows, vl


def check_flash(torch, F, dev, gen):
    """``flash_decode`` at every shape of ``FLASH_SHAPES`` and
    ``FLASH_DENSE_SHAPES`` in f32 and bf16 against its plain version; two
    calls on the same inputs must be bit-identical; bf16 at S = 8192 and
    at each dense shape timed (the latter under the shape's name)."""
    out = {}
    for s_len in (FLASH_SHAPES["global"]["s_len"],
                  FLASH_SHAPES["ring"]["s_len"]):
        case = flash_case(torch, F, dev, gen, s_len, timed=s_len == 8192)
        if s_len == 8192:
            out.update(case)
        else:
            out.update({f"{k}_S{s_len}": v for k, v in case.items()})
    for name, shape in FLASH_DENSE_SHAPES.items():
        g, kw = seeded(torch, dev, gen, shape)
        out[name] = flash_case(torch, F, dev, g, timed=True, **kw)
    return out


def flash_case(torch, F, dev, gen, s_len, timed, **geometry):
    """One ``flash_decode`` shape (``flash_inputs``' keywords) in f32 and
    bf16 against the plain version, two calls bit-identical; with
    ``timed``, the bf16 call's timings, bound and shape."""
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for dtype in ("float32", "bfloat16"):
        args = flash_inputs(torch, dev, gen, getattr(torch, dtype), s_len,
                            **geometry)
        q, kc, vc, rows, vl = args
        n, h, hd = q.shape
        kvh = kc.shape[2]
        label = f"flash_decode S={s_len} H {h} KVH {kvh} hd {hd} {dtype}"
        o = fa.flash_decode(*args)
        o2 = fa.flash_decode(*args)
        op = fa.flash_decode_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(o, o2):
            fail(f"{label}: two calls on the same inputs differ")
        err = (o.float() - op.float()).abs().max().item()
        tol = 1e-4 if dtype == "float32" else 3e-2
        if not err <= tol:
            fail(f"{label}: max abs err {err} > {tol}")
        out[dtype] = err
        if dtype != "bfloat16" or not timed:
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
                           lambda: fa.flash_decode_plain(*args), library))
        keys = sum(vl_list)
        el = 2
        nbytes = keys * kvh * hd * 2 * el + 2 * q.numel() * el + 2 * n * 4
        ops = keys * h * 4 * hd
        out["bound_ms"], out["bound_by"] = bound(nbytes, ops, "bfloat16")
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
# D 5120, F 8192, 6 slots at 4 layers), the pipeline's batch-1 trace
# decode (one token, top-6, the layer's 64 experts as the slot buffer), and
# serve_trained's engines on the float32 53.5 M backbone at the 10% cache
# (11 slots): one token (batch 1), 4 decode lanes and a 5-token prefill
# chunk (batched), then main_run_236b's (DeepSeek-V2-236B: 4 lanes and an
# 8-token chunk, top-6, D 5120, F 1536, 48 slots; the chunk's 48 pairs name
# PREFILL_DISTINCT_SLOTS_236B distinct slots, the mean per call, 28.4, that
# main_run_236b showed on an H100)
PREFILL_DISTINCT_SLOTS = 19
PREFILL_DISTINCT_SLOTS_236B = 28
EXPERT_SHAPES = {
    "deepseek": dict(n=4, k=6, d=2048, f=1408, slots=166),
    "llama4": dict(n=4, k=1, d=5120, f=8192, slots=6),
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
    # serve_tiers' ship path: main run 1's decode on 166 slots plus the 48
    # ship rows (max(4 lanes, 8-token chunk) x top-6) past them, 8 of the
    # 24 distinct experts shipped; drawn from a seed of its own so the
    # shapes above keep their inputs
    "ship": dict(n=4, k=6, d=2048, f=1408, slots=166 + 48, ship=48,
                 seed=SEED + 24),
    "v236_decode": dict(n=4, k=6, d=5120, f=1536, slots=48, seed=SEED + 35),
    "v236_prefill": dict(n=8, k=6, d=5120, f=1536, slots=48,
                         distinct=PREFILL_DISTINCT_SLOTS_236B,
                         seed=SEED + 36),
    # the dispatch phase's per-shard call: 4 ranks x C 12 received tokens,
    # k 1, on the shard's 16 experts (each named 3 times)
    "dispatch": dict(n=48, k=1, d=2048, f=1408, slots=16, distinct=16,
                     seed=SEED + 40),
}


def check_expert(torch, dev, gen):
    """``expert_ffn`` at every shape of ``EXPERT_SHAPES``, the first at the
    top level."""
    out = expert_case(torch, dev, gen, **EXPERT_SHAPES["deepseek"])
    for name in list(EXPERT_SHAPES)[1:]:
        out[name] = expert_case(torch, dev, gen, **EXPERT_SHAPES[name])
    return out


def expert_inputs(torch, dev, gen, dt, n, k, d, f, slots, distinct=None,
                  ship=0):
    """(x, weights, slot_idx, wg, wu, wd) of one call: seeded random slot
    buffers, x and weights in type ``dt``; the n*k pairs name ``distinct``
    slots (all different when None), each used in turn, so a row's k slots
    are distinct as top-k makes them and the first pairs' slots recur.
    With ``ship`` rows (the last ones), a third of the distinct slots are
    ship rows, taken in order from the first as the engine stages them."""
    bufs = [(torch.randn(slots, *shape, generator=gen, device=dev)
             * 0.02).to(dt) for shape in ((d, f), (d, f), (f, d))]
    x = torch.randn(n, d, generator=gen, device=dev).to(dt)
    w = torch.rand(n, k, generator=gen, device=dev).to(dt)
    distinct = n * k if distinct is None else distinct
    if ship:
        m = distinct // 3
        pool = torch.cat([
            torch.randperm(slots - ship, generator=gen,
                           device=dev)[:distinct - m],
            torch.arange(slots - ship, slots - ship + m, device=dev)])
        pool = pool[torch.randperm(distinct, generator=gen, device=dev)]
    else:
        pool = torch.randperm(slots, generator=gen, device=dev)[:distinct]
    sl = pool[torch.arange(n * k, device=dev) % distinct].to(
        torch.int32).reshape(n, k)
    return x, w, sl, *bufs


def expert_case(torch, dev, gen, n, k, d, f, slots, distinct=None,
                timed="bfloat16", ship=0, seed=None):
    """One shape in f32 and bf16 against the plain version; two calls on
    the same inputs must be bit-identical; timed in the ``timed`` dtype
    (the one its run calls it in). ``seed`` draws the inputs from a
    generator of their own."""
    from repro_torch.kernels import expert_ffn as ef
    if seed is not None:
        gen = torch.Generator(dev).manual_seed(seed)
    out = {}
    for dtype in ("float32", "bfloat16"):
        args = expert_inputs(torch, dev, gen, getattr(torch, dtype), n, k, d,
                             f, slots, distinct, ship)
        sl = args[2]
        if ship and not (sl >= slots - ship).any():
            fail(f"expert_ffn ship shape names no ship row: {sl.tolist()}")
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
            if ship:
                rows = sorted({s for s in sl.reshape(-1).tolist()
                               if s >= slots - ship})
                out["ship_rows"] = rows
                out["shape"] += (f", {len(rows)} of them ship rows "
                                 f"{rows[0]}-{rows[-1]}")
        del args
    return out


# topk_gating's shapes on the main path: main run 1's router at decode (4
# lanes) and at a prefill chunk (8 tokens of one request), 64 experts top-6,
# main run 2's (16 experts, top-1), the pipeline's batch-1 trace decode, and
# the training forward's ids: the train phase's B 4 x S 1024 tokens (64
# experts, top-6) and pipeline_trained's B 8 x S 256 (16 experts, top-2),
# then serve_trained's batched decode (4 lanes) and prefill chunk (5
# tokens) on the 53.5 M backbone (its batch-1 row is pipeline_trained's),
# and main_run_236b's decode and prefill chunk (160 experts, top-6)
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
    "v236_decode": dict(t=4, e=160, k=6, seed=SEED + 37),
    "v236_prefill": dict(t=8, e=160, k=6, seed=SEED + 38),
}


def check_topk(torch, dev, gen, floor_ms):
    """``topk_gating`` at every shape of ``TOPK_SHAPES``, the first at the
    top level; ``floor_ms`` is this run's ``launch_floor_ms``."""
    out = topk_case(torch, dev, gen, floor_ms, **TOPK_SHAPES["deepseek"])
    for name in list(TOPK_SHAPES)[1:]:
        g, kw = seeded(torch, dev, gen, TOPK_SHAPES[name])
        out[name] = topk_case(torch, dev, g, floor_ms, **kw)
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
# the run must launch); each is served at full width in bfloat16.
# Llama-4-Scout keeps one 3:1 chunked:global group of its 48 layers (the
# script's time limit); DeepSeek-V2-236B 4 of its 60 layers (1 dense, 3
# MoE): a MoE layer's 160 routed experts are 7.55 GB, so 59 would pin
# 445 GB of host memory
MAIN_RUNS = {
    "deepseek-v2-lite": (None, 64, ("paged_flash_decode", "expert_ffn",
                                    "topk_gating")),
    "llama4-scout-17b-a16e": (4, 32, ("paged_flash_decode", "flash_decode",
                                      "expert_ffn", "topk_gating")),
    "deepseek-v2-236b": (4, 64, ("paged_flash_decode", "expert_ffn",
                                 "topk_gating")),
}
# the string compute clocks' constants: this card's bf16 dense peak and
# memory rate, the ones phase 2's bounds use
H100_ROOFLINE = (PEAK_OPS["bfloat16"], HBM_BYTES_S)


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


MAIN_MAX_NEW, MAIN_CACHE_LEN = 32, 128


def drive_main(torch, np, eng, prompt_len, need, label):
    """Serve a main run's 4 seeded prompts (``MAIN_MAX_NEW`` new tokens
    each) through ``eng``, counting launches from zero; fails on a kernel
    of ``need`` never launched or a malformed stream. Returns (streams,
    routed ids, their kinds, run seconds, launches)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    vocab = eng.cfg.vocab_size
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, vocab, prompt_len).tolist() for _ in range(4)]
    kinds = []
    routes = record_routes(eng.core, check_finite=True, kinds=kinds)
    reset_launch_counts()
    t1 = time.perf_counter()
    outs = eng.generate(prompts, MAIN_MAX_NEW, MAIN_CACHE_LEN)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = launch_counts()
    for name in need:
        if launches[name] == 0:
            fail(f"{label} never launched the {name} kernel")
    for s in outs:
        if len(s) != MAIN_MAX_NEW + 1 or not all(0 <= x < vocab for x in s):
            fail(f"bad stream from the {label}: {s}")
    return outs, routes, kinds, run_s, launches


def main_run(torch, np, dev, arch, host_bw, predictor=None, keep=None,
             layer_compute_s=0.0, roofline=None, handed=None):
    """One main run: ``arch`` at full width in bfloat16 through
    ``BatchedOffloadEngine`` with ``OnlineMoEBeyondPolicy``, holding a
    full-size predictor drawn from a seed, or ``predictor`` = (params,
    config) when given, under the compute clock ``layer_compute_s`` (a
    string clock takes ``roofline`` = (peak_flops, hbm_bw)). With ``keep``
    (a dict), the backbone is handed on as ``keep[arch]`` = (model,
    params, capacity); ``handed`` serves such a backbone instead of
    building one. Returns (result, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.core.predictor import predictor_init
    from repro_torch.models.model import build_model
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    depth, prompt_len, need = MAIN_RUNS[arch]
    cfg = get_config(arch)
    full_depth = cfg.num_layers
    m = cfg.moe
    per_layer = m.num_experts * 3 * cfg.d_model * m.d_ff_expert * 2
    avail = host_available_bytes()
    torch.cuda.reset_peak_memory_stats()     # the peak of this run's model
    t0 = time.perf_counter()
    if handed is None:
        n_layers = min(cfg.num_layers, depth or cfg.num_layers)
        # routed experts live in pinned host memory: cut depth (never
        # widths) further only if they would not fit beside a 16 GB
        # margin, keeping one whole block pattern so every layer kind runs
        fit = int((avail - 16e9) // per_layer) + m.first_dense_layers
        if fit < n_layers:
            n_layers = max(m.first_dense_layers
                           + max(2, len(cfg.block_pattern)), fit)
            log(f"{arch}: depth cut to {n_layers} layers: "
                f"{avail / 1e9:.1f} GB host memory available")
        cfg = cfg.replace(num_layers=n_layers)
        n_moe = n_layers - m.first_dense_layers
        capacity = max(int(0.10 * n_moe * m.num_experts), 4 * m.top_k)
        gen = torch.Generator(dev).manual_seed(SEED)
        model = build_model(cfg)
        params = model.init(gen, device=dev, expert_device="cpu")
    else:
        model, params, capacity = handed
        cfg = model.cfg
        n_layers = cfg.num_layers
        n_moe = n_layers - m.first_dense_layers
    if predictor is None:
        pc = predictor_config(PredictorConfig, cfg)
        pp = predictor_init(torch.Generator(dev).manual_seed(SEED + 1), pc,
                            device=dev)
    else:
        pp, pc = predictor
    eng = BatchedOffloadEngine(
        model, params, lambda: OnlineMoEBeyondPolicy(pp, pc), capacity,
        host_bw=host_bw, max_batch=4, block_size=8, prefill_chunk=8,
        layer_compute_s=layer_compute_s, roofline=roofline, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    outs, routes, kinds, run_s, launches = drive_main(
        torch, np, eng, prompt_len, need, f"{arch} main run")
    st = eng.stats
    generated = sum(len(s) for s in outs)
    result = {
        "config": cfg.name, "dtype": cfg.dtype, "layers": n_layers,
        "full_depth": full_depth, "depth_cut": n_layers != full_depth,
        "kinds": list(cfg.layer_kinds()), "requests": len(outs),
        "prompt_len": prompt_len, "max_new": MAIN_MAX_NEW,
        "cache_len": MAIN_CACHE_LEN, "max_batch": 4, "block_size": 8,
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
        "layer_compute_s": layer_compute_s, "roofline": roofline,
        "blocking_stall_s": st.blocking_stall_s,
        "overlapped_s": st.overlapped_s, "calib": eng.core._calib,
        # the clock's mean (attention, FFN) half per layer before calib
        "mean_layer_s": [sum(h) / len(h) for h in zip(*eng.core._layer_s)],
    }
    if keep is not None:
        keep[arch] = (model, params, capacity)
    del eng, params, pp
    return result, launches


ARCH_236B = "deepseek-v2-236b"
# what a compute clock may not move: it only prices the modeled transfers
CLOCK_EQUAL = ("stream_digest", "route_digest", "hits", "misses",
               "fetch_bytes", "steps", "prefill_chunks", "prefill_tokens")
CLOCK_REPORT = ("init_s", "run_s", "generated_tokens_per_s", "hit_rate",
                "fetch_bytes", "sim_stall_s", "blocking_stall_s",
                "overlapped_s", "mean_layer_s", "calib",
                "distinct_slots_per_expert_call")


def pinned_bytes(torch, params) -> dict:
    """The routed experts' bytes, and what PyTorch's pinned host allocator
    takes for them: it rounds each block up to a power of two, so a
    2.52 GB (E, D, F) tensor of DeepSeek-V2-236B holds 4 GiB."""
    from repro_torch.serving.offload import ROUTED
    tensors = [lp["moe"][k] for lp in params["layers"] if "moe" in lp
               for k in ROUTED]
    nbytes = [t.numel() * t.element_size() for t in tensors]
    out = {"expert_bytes": sum(nbytes),
           "pow2_rounded_bytes": sum(1 << (n - 1).bit_length()
                                     for n in nbytes),
           "all_pinned": all(t.is_pinned() for t in tensors)}
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:   # what the allocator holds, all blocks included
        out["host_allocator_bytes"] = stats().get("allocated_bytes.current")
    return out


def main_run_236b(torch, np, dev, host_bw):
    """DeepSeek-V2-236B at full width, 4 of its 60 layers, through
    ``main_run``: built once, then served three times on that backbone,
    under ``layer_compute_s`` 0.0, ``"roofline"`` and ``"measured"`` (the
    clocks at this card's ``H100_ROOFLINE``). A clock moves no token:
    fails unless every run's ``CLOCK_EQUAL`` entries and launches equal
    the first's. Returns (the first run's result with every run under
    ``clocks``, its launches)."""
    keep = {}
    first, launches = main_run(torch, np, dev, ARCH_236B, host_bw, keep=keep)
    first["pinned"] = pinned_bytes(torch, keep[ARCH_236B][1])
    clocks = {"0.0": first}
    for clock in ("roofline", "measured"):
        run, got = main_run(torch, np, dev, ARCH_236B, host_bw,
                            layer_compute_s=clock, roofline=H100_ROOFLINE,
                            handed=keep[ARCH_236B])
        for key in CLOCK_EQUAL:
            if run[key] != first[key]:
                fail(f"main_run_236b {clock}: {key} {run[key]} differs from "
                     f"the 0.0 clock's {first[key]}")
        if got != launches:
            fail(f"main_run_236b {clock}: launches {got} differ from the "
                 f"0.0 clock's {launches}")
        clocks[clock] = run
    del keep
    result = dict(first)
    result["clocks"] = {c: {k: r[k] for k in CLOCK_REPORT}
                        for c, r in clocks.items()}
    result["same_across_clocks"] = list(CLOCK_EQUAL) + ["launches"]
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


# telemetry's deterministic content (what a card run and a CPU run, or a
# telemetry run and main run 1, must share): (a) every metric's total but
# the two wall histograms, (b) every metric's point count, (c) the channel
# tracks' events exactly (the modeled clock), (d) the request and engine
# tracks' events without timestamps (the wall clock), (e) the scoreboard
WALL_METRICS = ("step.wall_s", "prefill.wall_s")
SCORE_KEYS = ("tp", "fp", "fn", "t01_hits", "t01_misses")


def telemetry_content(tel) -> dict:
    """(a)-(e) above from a ``Telemetry``; reads host lists only."""
    from repro_torch.serving.telemetry import METRICS, PID_CHANNELS
    events = tel.events()
    total = tel.scoreboard()["total"]
    return {
        "totals": {n: tel.total(n) for n in sorted(METRICS)
                   if n not in WALL_METRICS},
        "points": {n: sum(p.count for p in tel.series(n, 1.0))
                   for n in sorted(METRICS)},
        "channels": [[e["tid"], e["ph"], e["name"], e["ts"], e.get("dur"),
                      e.get("args")] for e in events
                     if e["pid"] == PID_CHANNELS],
        "tracks": [[e["pid"], e["tid"], e["ph"], e["name"], e.get("args")]
                   for e in events if e["pid"] != PID_CHANNELS],
        "score": {k: total[k] for k in SCORE_KEYS}}


def check_same_telemetry(label, card, cpu) -> None:
    """card/cpu: ``telemetry_content`` of the two runs."""
    for part in cpu:
        if card[part] != cpu[part]:
            fail(f"{label}GPU/CPU telemetry differs in {part}")


def export_trace(tel, path: Path, min_request_tracks: int,
                 min_channel_tracks: int) -> dict:
    """Write ``tel``'s Chrome trace with its scoreboard to ``path`` and
    validate it with ``tools/check_trace.py`` in a subprocess (stdlib
    only); fails unless it exits 0. Returns the export's figures."""
    t0 = time.perf_counter()
    doc = tel.to_chrome_trace()
    doc["scoreboard"] = tel.scoreboard()
    text = json.dumps(doc)
    path.parent.mkdir(exist_ok=True)
    path.write_text(text)
    export_s = time.perf_counter() - t0
    check = subprocess.run(
        [sys.executable, str(HERE / "tools" / "check_trace.py"), str(path),
         "--min-request-tracks", str(min_request_tracks),
         "--min-channel-tracks", str(min_channel_tracks)],
        capture_output=True, text=True, timeout=300)
    if check.returncode != 0:
        fail(f"tools/check_trace.py refused {path.name}: {check.stderr}")
    return {"events": len(doc["traceEvents"]), "trace_bytes": len(text),
            "export_s": export_s, "check_trace": check.stdout.strip()}


MAIN_RUN_EQUAL = ("hits", "misses", "fetch_bytes", "steps", "prefill_chunks",
                  "prefill_tokens", "sim_stall_s")


def serve_telemetry_run(torch, np, dev, host_bw, handed, main1):
    """Main run 1 again with ``ServeConfig.telemetry`` on: the backbone
    main run 1 built (``handed``: model, params, capacity; ``model.init``
    put its routed experts in pinned host memory), the same seeded
    predictor, prompts, 10% cache and host rate. Fails unless
    streams, routed ids, launches and the counters of ``MAIN_RUN_EQUAL``
    equal main run 1's (``main1``: its result and launches), the
    telemetry's counters mirror ``EngineStats`` (hits, misses, 4 admitted
    and retired, one ``step.wall_s`` point a step and one
    ``prefill.wall_s`` point a chunk), and ``tools/check_trace.py``
    accepts the trace (``chiprun_out/serve_telemetry_trace.json``)."""
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.core.predictor import predictor_init
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.scheduler import BatchedOffloadEngine
    from repro_torch.serving.telemetry import PID_ENGINE, Telemetry

    model, params, capacity = handed
    cfg = model.cfg
    pc = predictor_config(PredictorConfig, cfg)
    pp = predictor_init(torch.Generator(dev).manual_seed(SEED + 1), pc,
                        device=dev)
    tel = Telemetry()
    eng = BatchedOffloadEngine(
        model, params, lambda: OnlineMoEBeyondPolicy(pp, pc), capacity,
        host_bw=host_bw, serve=ServeConfig(max_batch=4, block_size=8,
                                           prefill_chunk=8, telemetry=tel),
        device=dev)
    _, prompt_len, need = MAIN_RUNS["deepseek-v2-lite"]
    outs, routes, _, run_s, launches = drive_main(
        torch, np, eng, prompt_len, need, "serve_telemetry run")
    first, first_launches = main1
    st = eng.stats
    where = "serve_telemetry"
    for key, got in (("stream_digest", digest(outs)),
                     ("route_digest", digest(routes)),
                     *((k, getattr(st, k)) for k in MAIN_RUN_EQUAL)):
        if got != first[key]:
            fail(f"{where}: {key} {got} differs from main run 1's "
                 f"{first[key]}")
    if launches != first_launches:
        fail(f"{where}: launches {launches} differ from main run 1's "
             f"{first_launches}")
    content = telemetry_content(tel)
    totals, points = content["totals"], content["points"]
    mirrors = {"cache.hit": (totals["cache.hit"], st.hits),
               "cache.miss": (totals["cache.miss"], st.misses),
               "sched.admitted": (totals["sched.admitted"], len(outs)),
               "sched.retired": (totals["sched.retired"], len(outs)),
               "step.wall_s points": (points["step.wall_s"], st.steps),
               "prefill.wall_s points": (points["prefill.wall_s"],
                                         st.prefill_chunks)}
    for name, (got, want) in mirrors.items():
        if got != want:
            fail(f"{where}: telemetry {name} {got} != {want}")
    trace = export_trace(tel, HERE / "chiprun_out"
                         / "serve_telemetry_trace.json",
                         min_request_tracks=len(outs), min_channel_tracks=1)
    stalls = {}
    for e in tel.events():
        if e["pid"] == PID_ENGINE and e["name"] == "stall":
            row = stalls.setdefault(str(e["args"]["critical_tier"]),
                                    {"n": 0, "stall_s": 0.0})
            row["n"] += 1
            row["stall_s"] += e["args"]["stall_s"]
    by_name = {}
    for e in tel.events():
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    score = tel.scoreboard()["total"]
    del eng, pp
    return {"config": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
            "requests": len(outs), "capacity_slots": capacity,
            "host_bw_bytes_per_s": host_bw, "run_s": run_s,
            "main_run_s": first["run_s"],
            "overhead": run_s / first["run_s"] - 1.0,
            "same_as_main_run": list(MAIN_RUN_EQUAL) + [
                "stream_digest", "route_digest", "launches"],
            "events_by_name": by_name, **trace,
            "step_wall_s": tel.hist("step.wall_s"),
            "prefill_wall_s": tel.hist("prefill.wall_s"),
            "scoreboard_total": score,
            "stall_instants_by_critical_tier": stalls,
            "totals": totals, "launches": launches}, launches


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


def parity_run_236b(torch, np, dev):
    """The reduced DeepSeek-V2-236B in float32 (MLA with the compressed q
    projection, ``q_lora_rank`` 64), card against CPU, through the paged
    engine under the ``"roofline"`` clock at ``H100_ROOFLINE`` on both
    sides: identical streams, routed ids and ``EngineStats`` (every field,
    the modeled stall bit for bit), every kernel of the path launched on
    the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    cfg = get_reduced(ARCH_236B)
    model = build_model(cfg)
    gen = torch.Generator(dev).manual_seed(SEED + 30)
    params = model.init(gen, device="cpu")          # drawn on the card
    pc = predictor_config(PredictorConfig, cfg)
    pp_gpu, pp_cpu = predictor_pair(torch, dev, pc, SEED + 31)
    rng = np.random.default_rng(SEED + 32)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (11, 6)]
    capacity = 2 * cfg.moe.top_k          # max_batch x top-k: every expert
    serve = ServeConfig(max_batch=2, block_size=8, prefill_chunk=8,
                        layer_compute_s="roofline")
    runs = {}
    for where, pp in (("card", pp_gpu), ("cpu", pp_cpu)):
        reset_launch_counts()
        eng = BatchedOffloadEngine(
            model, params, lambda pp=pp: OnlineMoEBeyondPolicy(pp, pc),
            capacity, host_bw=PARITY_HOST_BW, roofline=H100_ROOFLINE,
            serve=serve, device=dev if where == "card" else "cpu")
        routes = record_routes(eng.core, check_finite=True)
        outs = eng.generate(prompts, 6, 32)
        eng.pool.check_leaks(expected_in_use=0)
        st = eng.stats.as_dict()
        st.pop("latency")
        runs[where] = (outs, routes, st)
        if where == "card":
            launches = launch_counts()
            for name in MAIN_RUNS[ARCH_236B][2]:
                if launches[name] == 0:
                    fail(f"parity_236b never launched the {name} kernel")
        del eng
    check_same("parity_236b: ", runs["card"], runs["cpu"])
    if not runs["card"][2]["sim_stall_s"] > 0:
        fail("parity_236b: the roofline clock modeled no stall")
    return {"config": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
            "q_lora_rank": cfg.mla.q_lora_rank, "capacity_slots": capacity,
            "layer_compute_s": "roofline", "roofline": H100_ROOFLINE,
            "streams": runs["card"][0], "routing_steps": len(runs["card"][1]),
            "stats": runs["card"][2], "card_launches": launches,
            "identical": True}


# the open-loop phases: ``parity_workload`` replays one schedule on the
# card and on the CPU under a step clock (``DT`` fake seconds per decode
# step or prefill chunk); ``serve_workload`` serves a shared system prompt
# to two priority classes through ``run_workload`` on the real clock
WORKLOAD_DT = 1.0
# serve_workload serves the first 4 of main run 1's 27 layers (1 dense,
# 3 MoE; all 27 until the examples_cli phase needed the time, 14 until
# mesh_train's second model did): every check it makes is structural,
# and its time scales with the MoE layers
WORKLOAD = dict(background=8, urgent=2, system=64, suffix=12, max_new=32,
                urgent_max_new=8, arrivals=(0.25, 0.5), max_batch=4,
                block_size=8, prefill_chunk=8, cache_len=128,
                urgent_ttft_share=0.1, layers=4)


def parity_run_workload(torch, np, dev):
    """The prefix cache and preemption in float32 on the reduced
    DeepSeek-V2-Lite (TF32 off), card against CPU from the same weights,
    under one step clock. Six requests: four at priority 1 share a 2-block
    prefix (one is block-aligned, one ends mid-block inside the first
    one's indexed tail, so its match copies that block on write), then two
    urgent ones arrive while both lanes are busy and preempt. Fails unless streams,
    routed ids, ``EngineStats`` (``preemptions`` and ``latency``
    included), ``PoolStats`` and ``PrefixStats`` are identical, and the
    card run preempted, hit the index, copied on write and launched every
    kernel of the path."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.serving import scheduler
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.telemetry import Telemetry
    from repro_torch.serving.workload import SLO, StepClock, WorkloadRequest

    cfg = get_reduced("deepseek-v2-lite")          # float32
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 5),
                        device="cpu")
    pc = predictor_config(PredictorConfig, cfg)
    pp_gpu, pp_cpu = predictor_pair(torch, dev, pc, SEED + 6)
    rng = np.random.default_rng(SEED + 7)

    def tokens(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()
    shared, tail = tokens(16), tokens(5)
    # the last prompt ends mid-block inside the first one's indexed tail
    background = [shared + tail, shared + tokens(3), shared + tokens(8),
                  shared + tail[:3]]
    urgent = [(6.0, shared + tokens(4)), (12.0, tokens(6))]
    wl = ([WorkloadRequest(0.0, p, 10, priority=1, seed=i)
           for i, p in enumerate(background)]
          + [WorkloadRequest(at, p, 4, priority=0, seed=10 + i,
                             slo=SLO(ttft_s=4.0))
             for i, (at, p) in enumerate(urgent)])
    knobs = dict(max_batch=2, block_size=8, prefill_chunk=8,
                 layer_compute_s=2e-4, prefix_cache=True, preemption=True)
    runs = {}
    for where, pp in (("card", pp_gpu), ("cpu", pp_cpu)):
        tel = Telemetry()
        eng = scheduler.BatchedOffloadEngine(
            model, params, lambda pp=pp: OnlineMoEBeyondPolicy(pp, pc), 16,
            host_bw=PARITY_HOST_BW,
            serve=ServeConfig(telemetry=tel, **knobs),
            device=dev if where == "card" else "cpu")
        routes = record_routes(eng.core, check_finite=True)
        reset_launch_counts()
        # arrivals land at the same step on both sides: the scheduler's
        # clock counts this engine's steps and chunks
        scheduler.time = StepClock(WORKLOAD_DT).bind(eng)
        try:
            outs = eng.run_workload(wl, 48)
        finally:
            scheduler.time = time
        runs[where] = (outs, routes, eng.stats.as_dict(),
                       eng.pool.stats.as_dict(), eng.prefix.stats.as_dict(),
                       launch_counts(), telemetry_content(tel))
        del eng
    card, cpu = runs["card"], runs["cpu"]
    check_same("parity_workload: ", card[:3], cpu[:3])
    check_same_telemetry("parity_workload: ", card[6], cpu[6])
    for i, name in ((3, "PoolStats"), (4, "PrefixStats")):
        if card[i] != cpu[i]:
            fail(f"parity_workload: GPU/CPU {name} differ: {card[i]} vs "
                 f"{cpu[i]}")
    stats, pool, prefix, launches = card[2:6]
    if stats["preemptions"] < 1 or prefix["hits"] < 1 \
            or pool["cow_copies"] < 1:
        fail(f"parity_workload: the traffic did not preempt, hit and copy "
             f"on write: {stats['preemptions']} preemptions, {prefix}, "
             f"{pool['cow_copies']} copies")
    for name in MAIN_RUNS["deepseek-v2-lite"][2]:
        if launches[name] == 0:
            fail(f"parity_workload never launched the {name} kernel")
    return {"layers": cfg.num_layers, "dtype": "float32",
            "requests": len(wl), "streams": card[0],
            "routing_steps": len(card[1]), "stats": stats, "pool": pool,
            "prefix": prefix, "launches": launches,
            "telemetry_totals": card[6]["totals"], "identical": True}


def serve_workload_run(torch, np, dev, host_bw, handed):
    """Main run 1's backbone (``handed``: model, params, capacity; full
    width, bfloat16, seeded) cut to its first ``WORKLOAD["layers"]``
    layers (a shorter model over the same per-layer params, nothing
    copied) serving a shared 64-token system
    prompt through ``run_workload`` with the prefix cache and preemption
    on (``WORKLOAD``), a seeded full-size ``OnlineMoEBeyondPolicy`` per
    request, at a 10% cache of its MoE layers and this card's host rate,
    a ``LeakSanitizer`` on each engine. Eight
    priority-1 requests arrive at 0; two priority-0 ones at 0.25 and 0.5
    of a closed-loop run of the same requests on the same engine
    configuration with both features off, which also gives the comparison
    streams. The routed experts are pinned once, in place, and both
    engines read that one copy. Fails unless the run preempted, served at
    least 8 x 64 prompt positions from the index, cut ``prefill_tokens``
    by exactly the hit tokens less the positions preempted requests had
    processed (a resume brings those back, as hits or as prefill), leaked
    no block (at the end and, under the sanitizer, at every one of the 10
    retires of each run), launched each kernel of the path and gave
    well-formed streams. The streams are reported against the closed
    loop's, not required equal: in bfloat16 another batch composition rounds
    differently."""
    from repro_torch.analysis import LeakSanitizer
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.metrics import latency_stats
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.core.predictor import predictor_init
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.scheduler import BatchedOffloadEngine
    from repro_torch.serving.workload import SLO, WorkloadRequest

    c = WORKLOAD
    model, params, _ = handed
    full_depth = model.cfg.num_layers
    cfg = model.cfg.replace(num_layers=min(c["layers"], full_depth))
    model = build_model(cfg)
    params = {**params, "layers": params["layers"][:cfg.num_layers]}
    m = cfg.moe
    capacity = max(int(0.10 * (cfg.num_layers - m.first_dense_layers)
                       * m.num_experts), 4 * m.top_k)
    pin_s = pin_experts(params)
    pc = predictor_config(PredictorConfig, cfg)
    pp = predictor_init(torch.Generator(dev).manual_seed(SEED + 1), pc,
                        device=dev)
    rng = np.random.default_rng(SEED + 8)
    system = rng.integers(0, cfg.vocab_size, c["system"]).tolist()
    n_req = c["background"] + c["urgent"]
    prompts = [system + rng.integers(0, cfg.vocab_size, c["suffix"]).tolist()
               for _ in range(n_req)]
    max_new = [c["max_new"]] * c["background"] + \
        [c["urgent_max_new"]] * c["urgent"]
    priority = [1] * c["background"] + [0] * c["urgent"]

    def engine(on):
        return BatchedOffloadEngine(
            model, params, lambda: OnlineMoEBeyondPolicy(pp, pc), capacity,
            host_bw=host_bw, serve=ServeConfig(
                max_batch=c["max_batch"], block_size=c["block_size"],
                prefill_chunk=c["prefill_chunk"], prefix_cache=on,
                preemption=on), device=dev)

    where = "serve_workload"
    leak_checks = {}

    def sanitized(label, eng, drive):
        """``drive()`` under a LeakSanitizer: a sweep at every retire."""
        with LeakSanitizer(eng) as san:
            out = drive()
        if san.checks != n_req:
            fail(f"{where}: {san.checks} leak checks in the {label} run, "
                 f"want one per retired request ({n_req})")
        leak_checks[label] = san.checks
        return out

    eng = engine(False)
    for i in range(n_req):
        eng.submit(prompts[i], max_new[i], priority=priority[i], seed=i)
    record_routes(eng.core, check_finite=True)
    t0 = time.perf_counter()
    closed = sanitized("closed_loop", eng, lambda: eng.run(c["cache_len"]))
    closed_s = since(torch, t0)
    closed_stats = eng.stats.as_dict()
    eng.pool.check_leaks(expected_in_use=0)
    del eng
    release_host_memory(torch)

    eng = engine(True)
    ttft_slo = SLO(ttft_s=c["urgent_ttft_share"] * closed_s)
    wl = [WorkloadRequest(0.0, prompts[i], max_new[i], priority=1, seed=i)
          for i in range(c["background"])]
    wl += [WorkloadRequest(at * closed_s, prompts[c["background"] + j],
                           c["urgent_max_new"], priority=0,
                           seed=c["background"] + j, slo=ttft_slo)
           for j, at in enumerate(c["arrivals"])]
    resumed = []                 # positions each victim had processed
    preempt = eng._preempt

    def recording_preempt(lanes, victim):
        resumed.append(victim.t)
        preempt(lanes, victim)
    eng._preempt = recording_preempt
    routes = record_routes(eng.core, check_finite=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = sanitized("open_loop", eng,
                     lambda: eng.run_workload(wl, c["cache_len"]))
    run_s = since(torch, t0)
    launches = launch_counts()
    st, pool, prefix = eng.stats, eng.pool.stats, eng.prefix.stats
    cached = eng.prefix.cached_blocks
    eng.pool.check_leaks(expected_in_use=cached)
    if st.preemptions < 1:
        fail(f"{where}: no request was preempted")
    if prefix.hit_tokens < c["background"] * c["system"]:
        fail(f"{where}: {prefix.hit_tokens} prompt positions from the "
             f"index, want >= {c['background'] * c['system']}")
    saved = closed_stats["prefill_tokens"] - st.prefill_tokens
    if saved != prefix.hit_tokens - sum(resumed):
        fail(f"{where}: prefill_tokens fell by {saved}, want hit tokens "
             f"{prefix.hit_tokens} less resumed positions {sum(resumed)}")
    for name in MAIN_RUNS["deepseek-v2-lite"][2]:
        if launches[name] == 0:
            fail(f"{where} never launched the {name} kernel")
    for rid in range(n_req):
        s = outs[rid]
        if len(s) != max_new[rid] + 1 or not all(0 <= x < cfg.vocab_size
                                                 for x in s):
            fail(f"{where}: bad stream {rid}: {s}")
    recs = eng.records()
    by_class = {}
    for p in (0, 1):
        lat = latency_stats([r for r in recs.values() if r.priority == p],
                            st.latency.elapsed_s)
        by_class[f"priority_{p}"] = {k: lat.as_dict()[k] for k in (
            "n", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "slo_requests",
            "slo_met", "slo_attainment", "preemptions")}
    divergence = {}
    for rid in range(n_req):
        a, b = outs[rid], closed[rid]
        if a != b:
            divergence[rid] = next((i for i, (x, y) in enumerate(zip(a, b))
                                    if x != y), min(len(a), len(b)))
    generated = sum(len(s) for s in outs.values())
    del eng
    return {"config": cfg.name, "dtype": cfg.dtype, **c,
            "layers": cfg.num_layers, "full_depth": full_depth,
            "requests": n_req, "capacity_slots": capacity,
            "host_bw_bytes_per_s": host_bw, "pin_s": pin_s,
            "leak_checks": leak_checks,
            "policy": "moe-beyond-online (seeded)",
            "closed_loop_s": closed_s, "run_s": run_s,
            "urgent_ttft_slo_s": ttft_slo.ttft_s,
            "arrival_s": [w.arrival_s for w in wl],
            "positions_per_s": st.tokens / run_s,
            "generated_tokens_per_s": generated / run_s,
            "closed_loop_positions_per_s": closed_stats["tokens"] / closed_s,
            "latency_by_priority": by_class,
            "preemptions": st.preemptions, "resumed_positions": resumed,
            "prefix": prefix.as_dict(), "prefix_hit_rate": prefix.hit_rate,
            "cached_blocks": cached,
            "hit_rate": st.hit_rate, "closed_loop_hit_rate":
                closed_stats["hits"] / max(closed_stats["hits"]
                                           + closed_stats["misses"], 1),
            "fetch_bytes": st.fetch_bytes,
            "closed_loop_fetch_bytes": closed_stats["fetch_bytes"],
            "prefill_tokens": st.prefill_tokens,
            "closed_loop_prefill_tokens": closed_stats["prefill_tokens"],
            "steps": st.steps, "prefill_chunks": st.prefill_chunks,
            "closed_loop_steps": closed_stats["steps"],
            "closed_loop_prefill_chunks": closed_stats["prefill_chunks"],
            "cow_copies": pool.cow_copies, "retains": pool.retains,
            "preempt_ref_drops": pool.preempt_ref_drops,
            "kv_high_water_blocks": pool.high_water,
            "streams_equal_closed_loop": n_req - len(divergence),
            "first_divergence": divergence, "launches": launches,
            "stream_digest": digest([outs[r] for r in range(n_req)]),
            "route_digest": digest(routes)}, launches


def pin_experts(params) -> float:
    """Pin the routed experts of ``params`` in place (those not pinned
    yet), so the engines' stores read them without a copy; returns the
    seconds it took."""
    from repro_torch.serving.offload import ROUTED
    t0 = time.perf_counter()
    for lp in params["layers"]:
        if "moe" in lp:
            for k in ROUTED:
                if not lp["moe"][k].is_pinned():
                    lp["moe"][k] = lp["moe"][k].pin_memory()
    return time.perf_counter() - t0


# the tiered phases' spill files: a directory of the checkout on disk (the
# full-width one is ~2.2 GB), never the temporary directory
SPILL_DIR = HERE / "build" / "tier3_spill"
# parity_tiers prices ships as a slow peer computes them (80 GFLOP/s, 1
# TB/s): an expert one token needs is shipped, one two or more tokens
# share is fetched, so the reduced run takes both paths of "auto"
PARITY_TIERS_ROOFLINE = (8e10, 1e12)


def parity_run_tiers(torch, np, dev):
    """The tiered store in float32 on the reduced DeepSeek-V2-Lite (TF32
    off), card against CPU from the same weights: 4 shards with a disk
    spill, a tier-1 cache of 4, int8 cold tiers, auto dispatch and learned
    replacement with the learned policy, one host rate and one roofline
    on both sides. Fails unless streams, routed ids, every ``EngineStats``
    field (the by-tier dicts too), ``CacheStats`` and ``StoreStats`` are
    identical, the int8 codes and scales of every cold copy are equal,
    the run fetched from tiers 2 and 3 and shipped, each spill file is
    gone after ``close()``, and every kernel of the path launched."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.expertstore import TierConfig
    from repro_torch.serving.scheduler import BatchedOffloadEngine
    from repro_torch.serving.telemetry import Telemetry

    cfg = get_reduced("deepseek-v2-lite")          # float32
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 9),
                        device="cpu")
    pc = predictor_config(PredictorConfig, cfg)
    pp_gpu, pp_cpu = predictor_pair(torch, dev, pc, SEED + 10)
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (13, 5, 9)]
    SPILL_DIR.mkdir(parents=True, exist_ok=True)
    tiers = TierConfig(num_shards=4, shard_dram_experts=8, cache_experts=4,
                       cold_dtype="int8", dispatch="auto",
                       spill_dir=str(SPILL_DIR))
    knobs = dict(max_batch=2, block_size=8, prefill_chunk=8,
                 layer_compute_s=2e-5, tiers=tiers, replacement="learned")
    runs, stores = {}, {}
    for where, pp in (("card", pp_gpu), ("cpu", pp_cpu)):
        tel = Telemetry()
        eng = BatchedOffloadEngine(
            model, params, lambda pp=pp: OnlineMoEBeyondPolicy(pp, pc), 16,
            host_bw=PARITY_HOST_BW, roofline=PARITY_TIERS_ROOFLINE,
            serve=ServeConfig(telemetry=tel, **knobs),
            device=dev if where == "card" else "cpu")
        routes = record_routes(eng.core, check_finite=True)
        reset_launch_counts()
        outs = eng.generate(prompts, 6, 32)
        eng.pool.check_leaks(expected_in_use=0)
        st = eng.stats.as_dict()
        st.pop("latency")
        store = eng.core.store
        runs[where] = (outs, routes, st, eng.core.cache.stats.as_dict(),
                       store.stats.as_dict(), launch_counts(),
                       eng.dispatch_summary(), telemetry_content(tel))
        path = store._spill_path
        stores[where] = {k: v for k, v in store._cold.items()}, dict(
            store._spill_scales)
        store.close()
        if path is None or os.path.exists(path):
            fail(f"parity_tiers: the {where} store's spill file {path} is "
                 "not gone after close()")
        del eng, store
    card, cpu = runs["card"], runs["cpu"]
    check_same("parity_tiers: ", card[:3], cpu[:3])
    check_same_telemetry("parity_tiers: ", card[7], cpu[7])
    for i, name in ((3, "CacheStats"), (4, "StoreStats")):
        if card[i] != cpu[i]:
            fail(f"parity_tiers: GPU/CPU {name} differ: {card[i]} vs "
                 f"{cpu[i]}")
    (cold_card, scales_card), (cold_cpu, scales_cpu) = (stores["card"],
                                                        stores["cpu"])
    if sorted(cold_card) != sorted(cold_cpu):
        fail("parity_tiers: the card and the CPU quantized other keys")
    for key, (codes, scales) in cold_card.items():
        for a, b in zip(codes + scales, cold_cpu[key][0] + cold_cpu[key][1]):
            if not torch.equal(a, b):
                fail(f"parity_tiers: int8 cold copy of {key} differs "
                     "between the card's codec and the CPU's")
    for key, scales in scales_card.items():
        if not all(torch.equal(a, b) for a, b in zip(scales,
                                                     scales_cpu[key])):
            fail(f"parity_tiers: spill scales of {key} differ")
    stats, store_stats, launches = card[2], card[4], card[5]
    fetched = stats["fetches_by_tier"]
    if fetched.get(2, 0) < 1 or fetched.get(3, 0) < 1 or stats["ships"] < 1:
        fail(f"parity_tiers: the run did not fetch from tiers 2 and 3 and "
             f"ship: {fetched}, {stats['ships']} ships")
    for name in MAIN_RUNS["deepseek-v2-lite"][2]:
        if launches[name] == 0:
            fail(f"parity_tiers never launched the {name} kernel")
    return {"layers": cfg.num_layers, "dtype": "float32",
            "requests": len(prompts), "tiers": tiers.__dict__ | {
                "spill_dir": "build/tier3_spill"},
            "roofline": PARITY_TIERS_ROOFLINE, "streams": card[0],
            "routing_steps": len(card[1]), "stats": stats,
            "store": store_stats, "dispatch": card[6],
            "cold_copies_compared": len(cold_card) + len(scales_card),
            "launches": launches, "telemetry_totals": card[7]["totals"],
            "identical": True}


# serve_tiers: main run 1's backbone behind the tiered store; each run is
# (label, TierConfig fields, replacement). Run (a), one-layer horizons
# with fetch and LRU, is left out for time: its tier 0 decides exactly as
# main run 1's (PERF.md, PR 24), and the phase must stay near 150 s
SERVE_TIERS = dict(layer_compute_s=150e-6, num_shards=4, local_shard=0,
                   shard_dram_experts=384, cache_experts=166, max_new=32,
                   cache_len=128)
TIER_RUNS = (("b", dict(dispatch="fetch"), "lru"),
             ("c", dict(dispatch="auto"), "learned"),
             ("d", dict(dispatch="auto", cold_dtype="int8"), "learned"))


def serve_tiers_run(torch, np, dev, host_bw, handed, main1):
    """Main run 1's backbone (``handed``: model, params, capacity; full
    width and depth, bfloat16, its experts pinned once in place) behind
    the tiered store: 4 shards on the consistent-hash ring, this process
    shard 0, 384 home experts a shard in memory and the rest spilled to a
    file on disk, a tier-1 cache of 166 experts. Main run 1's 4 prompts,
    32 new tokens, 166 slots and seeded predictor, a 150 us layer clock
    (the card's own ``expert_ffn`` at this decode shape, PERF.md §6), this
    card's host rate and bf16 roofline. Runs (``TIER_RUNS``): (b) the
    tiers' horizons, fetch, LRU; (c) auto dispatch, learned replacement;
    (d) as (c) on int8 cold tiers. Fails unless (b) and (c) give main run
    1's stream and route digests (``main1``), (b) fetched from tier 2,
    every run from tier 3, (c) and (d) shipped, each (d) fetch from tiers
    2-3 moved the int8 wire size, every kernel of the path launched in
    every run, each spill file is gone after ``close()`` and (c), under a
    ``LeakSanitizer``, swept the pool and the residency ledger at each of
    its 4 retires."""
    import shutil

    from repro_torch.analysis import LeakSanitizer
    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.policies import OnlineMoEBeyondPolicy
    from repro_torch.core.predictor import predictor_init
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.expertstore import TierConfig
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    c = SERVE_TIERS
    model, params, capacity = handed
    cfg = model.cfg
    pin_s = pin_experts(params)
    pc = predictor_config(PredictorConfig, cfg)
    pp = predictor_init(torch.Generator(dev).manual_seed(SEED + 1), pc,
                        device=dev)
    rng = np.random.default_rng(SEED)
    prompt_len = MAIN_RUNS["deepseek-v2-lite"][1]
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
               for _ in range(4)]
    SPILL_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(SPILL_DIR).free
    roofline = (PEAK_OPS["bfloat16"], HBM_BYTES_S)
    results, total, streams = {}, {}, {}
    for label, kw, replacement in TIER_RUNS:
        tc = TierConfig(num_shards=c["num_shards"],
                        local_shard=c["local_shard"],
                        shard_dram_experts=c["shard_dram_experts"],
                        cache_experts=c["cache_experts"],
                        spill_dir=str(SPILL_DIR), **kw)
        t0 = time.perf_counter()
        eng = BatchedOffloadEngine(
            model, params, lambda: OnlineMoEBeyondPolicy(pp, pc), capacity,
            host_bw=host_bw, roofline=roofline, serve=ServeConfig(
                max_batch=4, block_size=8, prefill_chunk=8,
                layer_compute_s=c["layer_compute_s"], tiers=tc,
                replacement=replacement), device=dev)
        store = eng.core.store
        build_s = since(torch, t0)
        path = store._spill_path
        spill_bytes = os.path.getsize(path) if path else 0
        routes = record_routes(eng.core, check_finite=True)
        # run (c) under the leak sanitizer: the pool and the store's
        # residency ledger swept at every retire
        san = LeakSanitizer(eng).install() if label == "c" else None
        reset_launch_counts()
        t1 = time.perf_counter()
        outs = eng.generate(prompts, c["max_new"], c["cache_len"])
        run_s = since(torch, t1)
        launches = launch_counts()
        where = f"serve_tiers ({label})"
        if san is not None:
            san.uninstall()
            if san.checks != len(prompts):
                fail(f"{where}: {san.checks} leak checks, want one per "
                     f"retired request ({len(prompts)})")
        for name in MAIN_RUNS["deepseek-v2-lite"][2]:
            if launches[name] == 0:
                fail(f"{where} never launched the {name} kernel")
        for s in outs:
            if len(s) != c["max_new"] + 1 or not all(
                    0 <= x < cfg.vocab_size for x in s):
                fail(f"{where}: bad stream {s}")
        eng.pool.check_leaks(expected_in_use=0)
        st = eng.stats
        fetched, nbytes = st.fetches_by_tier, st.fetch_bytes_by_tier
        digests = {"stream_digest": digest(outs),
                   "route_digest": digest(routes)}
        if "cold_dtype" not in kw:      # bit-exact tiers: main run 1's
            for key, value in digests.items():
                if value != main1[key]:
                    fail(f"{where}: {key} {value} differs from main run "
                         f"1's {main1[key]}")
        if kw["dispatch"] == "fetch" and fetched.get(2, 0) < 1:
            fail(f"{where}: no fetch from tier 2: {fetched}")
        if fetched.get(3, 0) < 1:
            fail(f"{where}: no fetch from tier 3: {fetched}")
        if kw["dispatch"] != "fetch" and st.ships < 1:
            fail(f"{where}: nothing shipped")
        if kw.get("cold_dtype") == "int8":
            for tier in (2, 3):
                if nbytes.get(tier, 0) != (fetched.get(tier, 0)
                                           * store.cold_bytes_per_expert):
                    fail(f"{where}: tier-{tier} fetches moved {nbytes} "
                         f"bytes, not {store.cold_bytes_per_expert} each")
        # the tier-3 read rate of this host: every spilled expert once
        spilled = list(store._spill_row)
        t2 = time.perf_counter()
        read = 0
        for key in spilled:
            parts = store._read_spill(key)
            parts = parts.codes if hasattr(parts, "codes") else parts
            read += sum(p.numel() * p.element_size() for p in parts)
        read_s = time.perf_counter() - t2
        store.close()
        if path is None or os.path.exists(path):
            fail(f"{where}: spill file {path} is not gone after close()")
        streams[label] = outs
        results[label] = {
            "tiers": {**kw, "replacement": replacement}, "build_s": build_s,
            "run_s": run_s, "positions_per_s": st.tokens / run_s,
            "generated_tokens_per_s": sum(map(len, outs)) / run_s,
            "hit_rate": st.hit_rate, "hits": st.hits, "misses": st.misses,
            "sim_stall_s": st.sim_stall_s,
            "blocking_stall_s": st.blocking_stall_s,
            "overlapped_s": st.overlapped_s,
            "stall_by_tier": st.stall_by_tier,
            "overlapped_by_tier": st.overlapped_by_tier,
            "fetches_by_tier": fetched, "fetch_bytes_by_tier": nbytes,
            "fetch_bytes": st.fetch_bytes,
            "dispatch": eng.dispatch_summary(),
            "deep_prefetch_hits": st.deep_prefetch_hits,
            "horizon_clamps": st.horizon_clamps,
            "evictions_learned": st.evictions_learned,
            "evictions_lru": st.evictions_lru,
            "store": store.stats.as_dict(), "spill_bytes": spill_bytes,
            "spill_read_bytes": read, "spill_read_s": read_s,
            "spill_read_bytes_per_s": read / read_s if read_s else None,
            "spill_read_modeled_bytes_per_s": tc.disk_bw,
            "launches": launches, **digests,
            **({"leak_checks": san.checks} if san is not None else {})}
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del eng, store
        release_host_memory(torch)
        log(f"serve_tiers ({label}) done in {run_s:.1f} s "
            f"(store built in {build_s:.1f} s)")
    if "d" in results and "c" in results:     # int8 against bf16
        results["d"]["streams_equal_c"] = sum(
            a == b for a, b in zip(streams["d"], streams["c"]))
    return {"config": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
            **c, "requests": len(prompts), "capacity_slots": capacity,
            "host_bw_bytes_per_s": host_bw, "roofline": roofline,
            "pin_s": pin_s, "spill_dir_free_bytes": free,
            "main_run_digests": {k: main1[k] for k in (
                "stream_digest", "route_digest")},
            "runs": results, "launches": total}, total


# the pipeline phase: prompts from the topic corpus, decode steps per
# trace, predictor training split, and the simulator's cache (the paper's
# 10%) and warm-up prefix
# 20 traces, 12 of them training the predictor and 8 held out (32 and 24
# until the GQA phases of phases 9-11 needed the time, 24 and 16 until
# the checkpoint and dispatch phases did)
PIPELINE = dict(prompts=20, prompt_len=64, max_new=16, train=12,
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


# the examples_cli phase: the four example command lines of the port, in
# this process, on the card (argv without the output paths)
EXAMPLES_CLI = (
    ("collect_traces", ["--n", "8", "--max-new", "24",
                        "--train-steps", "30"]),
    ("train_predictor", ["--epochs", "3"]),
    ("train_backbone", ["--steps", "4", "--batch", "8", "--seq", "256"]),
    ("serve_with_cache", ["--tokens", "8", "--train-steps", "5",
                          "--n-train-traces", "2"]))


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, HERE / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_cli_run(torch, np, dev):
    """The port's four example command lines through their ``main(argv)``
    on ``dev`` (``--device cuda`` on the card; ``EXAMPLES_CLI``): traces
    and the predictor written to ``chiprun_out/examples_cli/``, the ~100M
    backbone's checkpoint to a temporary directory (214 MB, too large to
    bring back from the card's machine). Fails unless the trace
    file reads back through ``load_traces`` with (T, MoE layers, k)
    experts in range, the predictor file read through
    ``convert.predictor_from_jax_checkpoint`` equals the trained
    parameters bit for bit and gives the same logits on one batch, the
    backbone's file reloads bit for bit through ``checkpoint.load``, each
    command printed the reference CLI's lines, and ``topk_gating`` and
    ``expert_ffn`` launched. Each command's stdout goes to
    ``chiprun_out/examples_cli/<name>.txt``."""
    import contextlib
    import io
    import tempfile

    from repro_torch.configs import get_reduced
    from repro_torch.configs.deepseek_v2_lite import hundred_m_config
    from repro_torch.convert import predictor_from_jax_checkpoint
    from repro_torch.core.predictor import predictor_apply
    from repro_torch.core.tracing import load_traces, moe_layer_ids
    from repro_torch.data.traces import PredictorDataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import named_leaves

    where = "examples_cli"
    out_dir = HERE / "chiprun_out" / "examples_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    traces_path = out_dir / "traces.npz"
    pred_path = out_dir / "predictor.npz"
    tmp = tempfile.TemporaryDirectory()
    backbone_path = Path(tmp.name) / "backbone_100m.npz"
    paths = {"collect_traces": ["--out", str(traces_path)],
             "train_predictor": ["--traces", str(traces_path),
                                 "--out", str(pred_path)],
             "train_backbone": ["--save", str(backbone_path)],
             "serve_with_cache": []}
    expect = {"collect_traces": "saved 8 traces",
              "train_predictor": "saved predictor to",
              "train_backbone": "-param MoE (8L x 16e top-2)",
              "serve_with_cache": "cache hit rate:"}
    reset_launch_counts()
    returned, seconds, printed = {}, {}, {}
    for name, argv in EXAMPLES_CLI:
        main = load_example(f"{name}_torch").main
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            returned[name] = main(argv + paths[name]
                                  + ["--device", dev.type])
        seconds[name] = since(torch, t0)
        text = buf.getvalue()
        (out_dir / f"{name}.txt").write_text(text)
        if expect[name] not in text:
            fail(f"{where}: {name} did not print {expect[name]!r}:\n{text}")
        printed[name] = text.strip().splitlines()[-3:]
        log(f"{where}: {name} done in {seconds[name]:.1f} s")
    launches = launch_counts()
    for name in ("topk_gating", "expert_ffn"):
        if launches[name] == 0:
            fail(f"{where} never launched the {name} kernel")

    cfg = get_reduced("deepseek-v2-lite")
    traces = load_traces(str(traces_path))
    n_moe, k, e = len(moe_layer_ids(cfg)), cfg.moe.top_k, cfg.moe.num_experts
    for tr in traces:
        shape = tr.experts.shape
        if len(shape) != 3 or shape[1:] != (n_moe, k) or \
                not ((tr.experts >= 0) & (tr.experts < e)).all():
            fail(f"{where}: trace experts of shape {shape}, want (T, "
                 f"{n_moe}, {k}) in [0, {e})")
    if len(traces) != 8:
        fail(f"{where}: {len(traces)} traces read back, want 8")

    params, pc, hist = returned["train_predictor"]
    read = predictor_from_jax_checkpoint(str(pred_path), device=dev)
    mine, theirs = named_leaves(params), named_leaves(read)
    if [k for k, _ in mine] != [k for k, _ in theirs] or not all(
            torch.equal(a, b) for (_, a), (_, b) in zip(mine, theirs)):
        fail(f"{where}: the predictor file does not read back bit for bit")
    emb, lids, mask, _ = next(PredictorDataset(traces, pc).batches(
        4, shuffle=False))
    batch = [torch.as_tensor(a, device=dev) for a in (emb, lids, mask)]
    with torch.no_grad():
        same_logits = torch.equal(predictor_apply(params, pc, *batch),
                                  predictor_apply(read, pc, *batch))
    if not same_logits:
        fail(f"{where}: the reloaded predictor's logits differ")

    trained, losses = returned["train_backbone"]
    like = build_model(hundred_m_config()).init(device=dev)
    loaded = checkpoint.load(str(backbone_path), like)
    backbone_bytes = backbone_path.stat().st_size
    pairs = list(zip(named_leaves(trained), named_leaves(loaded)))
    if not all(ka == kb and a.dtype == b.dtype and torch.equal(a, b)
               for (ka, a), (kb, b) in pairs):
        fail(f"{where}: the backbone checkpoint does not reload bit for bit")
    del like, loaded, trained, params, read
    tmp.cleanup()
    return {"commands": {name: argv for name, argv in EXAMPLES_CLI},
            "seconds": seconds, "printed": printed,
            "traces": len(traces),
            "trace_experts_shape": list(traces[0].experts.shape),
            "predictor_leaves": len(mine), "predictor_bit_identical": True,
            "predictor_same_logits": same_logits,
            "predictor_best_val_loss": min(hist.val_loss),
            "backbone_leaves": len(pairs), "backbone_file_bytes":
                backbone_bytes, "backbone_bit_identical": True,
            "backbone_losses": losses, "launches": launches}, launches


# the checkpoint phase: full-width DeepSeek-V2-Lite cut to 1 dense and 1
# MoE layer (1.085 B parameters; its file, float32 as the reference's, is
# 4.34 GB), trained 2 steps by ``launch.train.train(save=)`` and reloaded
CHECKPOINT = dict(layers=2, batch=4, seq=1024, steps=2, lr=1e-3)


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


class RssPeak:
    """The process's resident set sampled every ``every`` s on a thread
    while the ``with`` block runs: the peak of one phase (the kernel's
    high-water mark is the whole process's)."""

    def __init__(self, every: float = 0.01):
        import threading
        self.every, self.peak = every, rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.every):
            self.peak = max(self.peak, rss_bytes())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def checkpoint_run(torch, np, dev):
    """``launch.train.train(save=)`` on full-width DeepSeek-V2-Lite (2
    layers, bfloat16, 2 AdamW steps at B 4 x S 1024) into a temporary
    directory, then ``checkpoint.load`` into a fresh ``model.init`` on the
    card. Fails if the directory's disk is short of the file, unless every
    leaf equals the trained one bit for bit in value, dtype, shape and
    device, unless ``loss_fn`` on a held-out batch gives identical loss
    and metrics for both trees, and unless ``topk_gating`` launched
    exactly once per MoE layer and forward (2 steps, 2 held-out
    forwards), no other kernel."""
    import resource
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches, make_topic_corpus
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import moe_layer_ids
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import named_leaves

    c = CHECKPOINT
    cfg = get_config("deepseek-v2-lite").replace(num_layers=c["layers"])
    n_moe = len(moe_layer_ids(cfg))
    model = build_model(cfg)
    shapes = model.init(torch.Generator(dev).manual_seed(SEED),
                        device="meta")
    n_params = sum(t.numel() for _, t in named_leaves(shapes))
    need = 4 * n_params + (64 << 20)    # float32 arrays, headers, slack
    rss_before = rss_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        if free < need:
            fail(f"checkpoint: {free} bytes free under {tmp}, the file "
                 f"needs {need}")
        path = os.path.join(tmp, "ckpt.npz")
        stamps = []

        def note(line):
            stamps.append((time.perf_counter(), line))
            log(f"checkpoint: {line}")

        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            params, losses = train(cfg, steps=c["steps"],
                                   batch_size=c["batch"], seq_len=c["seq"],
                                   lr=c["lr"], seed=SEED, device=dev,
                                   log=note, save=path)
            train_s = time.perf_counter() - t0
            train_launches = launch_counts()
            if stamps[-1][1] != f"saved params to {path}":
                fail(f"checkpoint: train logged {stamps[-1][1]!r} last")
            # from the last step's line (its loss read back) to the save's
            save_s = stamps[-1][0] - stamps[-2][0]
            file_bytes = os.path.getsize(path)
            fresh = model.init(torch.Generator(dev).manual_seed(SEED + 1),
                               device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = checkpoint.load(path, fresh)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            del fresh
    trained, back = named_leaves(params), named_leaves(loaded)
    if [k for k, _ in trained] != [k for k, _ in back]:
        fail("checkpoint: the loaded tree's keys differ from the trained")
    differ = [k for (k, a), (_, b) in zip(trained, back)
              if a.dtype != b.dtype or a.shape != b.shape
              or a.device != b.device or b.requires_grad
              or not torch.equal(a, b)]
    if differ:
        fail(f"checkpoint: leaves not restored bit for bit: {differ}")
    if not file_bytes >= 4 * n_params:
        fail(f"checkpoint: {file_bytes} bytes for {n_params} float32 values")
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=8, seed=SEED)
    held = torch.as_tensor(next(iter(lm_batches(
        corpus, c["batch"], c["seq"], 1, seed=SEED + 2)))[:, :c["seq"]],
        device=dev)
    reset_launch_counts()
    with torch.no_grad():
        la, ma = model.loss_fn(params, {"tokens": held})
        lb, mb = model.loss_fn(loaded, {"tokens": held})
    torch.cuda.synchronize()
    forward_launches = launch_counts()
    if not (torch.equal(la, lb)
            and all(torch.equal(ma[k], mb[k]) for k in ma)):
        fail(f"checkpoint: held-out loss {la.item()} / {ma} on the trained "
             f"tree, {lb.item()} / {mb} on the loaded one")
    for label, got, steps in (("train", train_launches, c["steps"]),
                              ("held-out forwards", forward_launches, 2)):
        want = {k: 0 for k in got}
        want["topk_gating"] = n_moe * steps
        if got != want:
            fail(f"checkpoint: {label} launched {got}, want {want}")
    if not np.isfinite(losses).all():
        fail(f"checkpoint: non-finite losses {losses}")
    launches = {k: train_launches[k] + forward_launches[k]
                for k in train_launches}
    result = {
        "config": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
        "moe_layers": n_moe, "params": n_params, "leaves": len(trained),
        "float32_leaves": [k for k, t in trained if t.dtype == torch.float32],
        **c, "losses": losses, "held_out_loss": la.item(),
        "held_out_metrics": {k: v.item() for k, v in ma.items()},
        "file_bytes": file_bytes, "disk_free_bytes": free,
        "train_s_with_save": train_s, "save_s": save_s, "load_s": load_s,
        "save_bytes_per_s": file_bytes / save_s,
        "load_bytes_per_s": file_bytes / load_s,
        "rss_before_bytes": rss_before, "peak_rss_bytes": rss.peak,
        "process_max_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "train_launches": train_launches,
        "forward_launches": forward_launches, "bit_identical": True}
    del params, loaded, trained, back, la, lb, ma, mb
    return result, launches


# the dispatch phase: 4 ranks on the one card, each holding 16 of
# DeepSeek-V2-Lite's 64 experts at full width, at two capacities: 4 x 12
# received pairs (one expert_ffn call) and 4 x 24 (two)
DISPATCH = dict(ranks=4, experts=64, d=2048, f=1408, capacities=(12, 24),
                timeout_s=120.0)


def dispatch_rank(rank: int, world: int, rendezvous: str, out_dir: str,
                  c: dict, device: str) -> None:
    """One rank of the dispatch phase, in a process of its own: a ``gloo``
    group of ``world`` ranks over ``file://`` rendezvous (NCCL refuses two
    ranks on one card), the global experts drawn on the card from one
    seed on every rank, this rank's 16 of them copied out, then at each
    capacity ragged send buffers (``-1`` padding, as the reference test
    draws them) through ``expert_dispatch_ffn`` in float32 and bfloat16,
    each against ``expert_ffn_plain`` of every sent token on its global
    expert in float32. ``c`` is ``DISPATCH``; ``device`` is ``"cuda"``
    (``"cpu"`` rehearses the phase on the plain path). Writes its report
    to ``out_dir``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import build, launch_counts, reset_launch_counts
    from repro_torch.kernels import expert_ffn as ef
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_expert_group

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        group = make_expert_group(world)
        if on_card:
            build.library()         # the parent's, from the build cache
        e, d, f = c["experts"], c["d"], c["f"]
        e_local = e // world
        gen = torch.Generator(dev).manual_seed(SEED + 50)
        glob = [(torch.randn(e, *shape, generator=gen, device=dev)
                 * 0.02).to(torch.bfloat16)
                for shape in ((d, f), (d, f), (f, d))]
        mine = [w[rank * e_local:(rank + 1) * e_local].contiguous()
                for w in glob]
        sync()
        ready_s = time.perf_counter() - t_start
        runs = []
        for cap in c["capacities"]:
            rng = np.random.default_rng(SEED + cap)   # equal on every rank
            eid = np.full((world, world, cap), -1, np.int32)
            for s in range(world):
                for dest in range(world):
                    live = int(rng.integers(0, cap + 1))
                    eid[s, dest, :live] = rng.integers(
                        dest * e_local, (dest + 1) * e_local, live)
            es = torch.from_numpy(eid[rank]).to(dev)
            received = int((eid[:, rank] >= 0).sum())
            xgen = torch.Generator(dev).manual_seed(SEED + 100 * cap + rank)
            x = torch.randn(world, cap, d, device=dev, generator=xgen)
            pad = (es < 0)[..., None].expand(world, cap, d)
            for dt in (torch.float32, torch.bfloat16):
                xs = x.to(dt)
                ws = [w.to(dt) for w in mine]
                ref = ef.expert_ffn_plain(
                    xs.float().reshape(-1, d),
                    torch.ones(world * cap, 1, device=dev),
                    es.clamp_min(0).reshape(-1, 1), *glob)
                ref = torch.where(pad, 0.0, ref.reshape(world, cap, d))
                first = sharding.expert_dispatch_ffn(group, *ws, xs, es)
                sync()
                dist.barrier(group=group)
                reset_launch_counts()
                t0 = time.perf_counter()
                out = sharding.expert_dispatch_ffn(group, *ws, xs, es)
                sync()
                call_s = time.perf_counter() - t0
                launches = launch_counts()
                err = (out.float() - ref).abs().max().item()
                scale = max(1.0, ref.abs().max().item())
                tol = (1e-4 if dt == torch.float32 else 2e-2) * scale
                runs.append({
                    "capacity": cap, "dtype": str(dt).split(".")[-1],
                    "pairs": world * cap, "received_live": received,
                    "sent_live": int((eid[rank] >= 0).sum()),
                    "launches": launches,
                    "want_expert_ffn": -(-world * cap // ef.MAX_PAIRS),
                    "max_abs_err": err, "tolerance": tol,
                    "padding_zero": bool((out[pad] == 0).all()),
                    "dtype_kept": out.dtype == dt,
                    "shape_kept": tuple(out.shape) == tuple(xs.shape),
                    "repeatable": torch.equal(out, first), "call_s": call_s})
                del ws, ref, first, out
        report = {"rank": rank, "shard_experts": list(
            range(rank * e_local, (rank + 1) * e_local)),
            "shard_bytes": sum(t.numel() * t.element_size() for t in mine),
            "ready_s": ready_s, "runs": runs,
            "wall_s": time.perf_counter() - t_start,
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated() if on_card else None}
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def dispatch_run(torch, np, dev):
    """``expert_dispatch_ffn`` on ``DISPATCH["ranks"]`` spawned ranks
    sharing the card (``dispatch_rank``). Fails if a rank raises, dies or
    outlasts ``timeout_s`` (every rank is stopped then), unless each run
    of each rank is within ``check_expert``'s tolerance of the plain
    version, keeps its dtype and shape, repeats bit for bit, has exact
    zeros at its padding and launched ``expert_ffn`` exactly
    ceil(S C / MAX_PAIRS) times and no other kernel."""
    import tempfile
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    # phase 1 built the kernel library: the ranks load it from the cache
    c = DISPATCH
    world = c["ranks"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            dispatch_rank, args=(world, os.path.join(tmp, "rendezvous"), tmp,
                                 c, dev.type),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + c["timeout_s"]
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    fail(f"dispatch: the ranks did not finish within "
                         f"{c['timeout_s']} s")
        except ProcessException as exc:
            fail(f"dispatch: rank {exc.error_index} failed: {exc}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        spawn_to_done_s = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(world)]
    total = 0
    for rep in ranks:
        for run in rep["runs"]:
            want = {k: 0 for k in run["launches"]}
            want["expert_ffn"] = run["want_expert_ffn"]
            label = (f"dispatch: rank {rep['rank']} C {run['capacity']} "
                     f"{run['dtype']}")
            if run["launches"] != want:
                fail(f"{label}: launches {run['launches']}, want {want}")
            if not run["max_abs_err"] <= run["tolerance"]:
                fail(f"{label}: max abs err {run['max_abs_err']} > "
                     f"{run['tolerance']}")
            for key in ("padding_zero", "dtype_kept", "shape_kept",
                        "repeatable"):
                if not run[key]:
                    fail(f"{label}: {key} is false")
            total += run["launches"]["expert_ffn"]
    launches = {k: 0 for k in ranks[0]["runs"][0]["launches"]}
    launches["expert_ffn"] = total
    result = {"ranks": world, "backend": "gloo", **{
        k: c[k] for k in ("experts", "d", "f", "capacities", "timeout_s")},
        "spawn_to_done_s": spawn_to_done_s,
        "rank_wall_s": [r["wall_s"] for r in ranks],
        "rank_ready_s": [r["ready_s"] for r in ranks],
        "call_s": {f"C{run['capacity']}_{run['dtype']}":
                   [r["runs"][i]["call_s"] for r in ranks]
                   for i, run in enumerate(ranks[0]["runs"])},
        "max_abs_err": {f"C{run['capacity']}_{run['dtype']}":
                        max(r["runs"][i]["max_abs_err"] for r in ranks)
                        for i, run in enumerate(ranks[0]["runs"])},
        "received_live": {f"C{run['capacity']}":
                          [r["runs"][i]["received_live"] for r in ranks]
                          for i, run in enumerate(ranks[0]["runs"])
                          if run["dtype"] == "float32"},
        "shard_bytes": ranks[0]["shard_bytes"],
        "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                       for r in ranks],
        "launches_per_rank": [sum(run["launches"]["expert_ffn"]
                                  for run in r["runs"]) for r in ranks]}
    return result, launches


# the mesh_train phase: 4 ranks sharing the card as a 2x2 ("data",
# "model") mesh train the checkpoint phase's model (full-width
# DeepSeek-V2-Lite, 2 layers, its seed and lr) 2 steps at B 8 x S 1024:
# 4 rows a data rank, one whole dispatch group of 4,096 tokens; then, in
# the same spawn, full-width internlm2-1.8b (GQA, an untied head) at the
# same depth, steps, batch and seed. DeepSeek-V2-Lite's runs go under the
# reference's activation sharding (``remat``): each scanned layer group
# recomputed, the sequence on "model" between groups (``act_spec``), its
# reduced run also without it
MESH_TRAIN = dict(ranks=4, mesh=(2, 2), batch=8, seq=1024, steps=2,
                  timeout_s=300.0, f32_tol=1e-5,
                  archs=("deepseek-v2-lite", "internlm2-1.8b"),
                  remat=("deepseek-v2-lite",), act_spec=("data", "model",
                                                         None))
# each rank's peak device memory in the mesh_train phase must stay below
# the highest rank's peak when every rank gathered the whole tree and
# all-reduced whole gradients (10,385,082,368 B on an NVIDIA H100 80GB
# HBM3 at 700 W, torch 2.11): allocation repeats for one torch and one
# code path
WHOLE_TREE_MESH_PEAK_BYTES = 10_385_082_368
# ... and below the highest rank's peak when each rank gathered every
# layer whole, one layer at a time, and computed all of it (8,630,632,448
# B on an NVIDIA H100 80GB HBM3 at 700.00 W, torch 2.11): computing the
# experts and MLA heads along "model" holds half of their buffers
PER_LAYER_MESH_PEAK_BYTES = 8_630_632_448
# ... and DeepSeek-V2-Lite's below the highest rank's peak when the
# experts and MLA heads computed along "model" but every rank formed the
# whole vocabulary's logits (7,907,950,592 B on an NVIDIA H100 80GB HBM3
# at 700.00 W, torch 2.11): a vocabulary shard halves the logits chunk
MODEL_PARALLEL_MESH_PEAK_BYTES = 7_907_950_592
# ... and DeepSeek-V2-Lite's below the highest rank's peak with the
# vocabulary along "model" too, with no recomputation (6,365,476,352 B on
# an NVIDIA H100 80GB HBM3 at 700.00 W, torch 2.11): recomputing its
# scanned MoE layer keeps that layer's input shard in place of its
# activations
VOCAB_PARALLEL_MESH_PEAK_BYTES = 6_365_476_352
# the bf16 losses' tolerance, relative: the f32 run holds the sharded step
# to the single-device one within f32_tol, so what is left between the
# bf16 runs is bfloat16 rounding of products whose row counts differ (4
# rows a rank against 8), one unit of bfloat16 rounding (2^-8) of the loss
BF16_LOSS_REL = 2.0 ** -8


def shard_shape(shape, places, mesh_shape):
    """The local shape of a leaf of ``shape`` under ``places`` on a mesh
    of ``mesh_shape`` (even splits)."""
    shape = list(shape)
    for k, pl in enumerate(places):
        if pl.is_shard():
            shape[pl.dim] //= mesh_shape[k]
    return shape


def model_reduced_want(cfg, rows: int, seq: int) -> int:
    """The bytes a rank all-reduces over ``"model"`` in one step of
    ``rows`` x ``seq`` tokens when every attention and MoE layer and the
    vocabulary compute along it (``launch/shardctx.enter_model``,
    ``leave_model``, ``model_max``; the mesh's ``"model"`` 2 divides the
    heads, KV heads, experts and vocabulary of both models, reduced and
    full): an MLA layer's input, latent and rope key (their gradients, in
    the model's dtype) and its output (float32); a GQA layer's input (its
    gradient) and output (float32); a MoE layer's input (its gradient),
    float32 combine weights (their gradient) and float32 output; the
    embedding's float32 sum; over the ``rows`` x (``seq`` - 1) scored
    tokens, the head input's gradient and the loss's three float32
    statistics (the maximum logit, the sum of exponentials, the target's
    logit), twice where the loss is sequence-chunked (checkpoint's
    recomputation runs them again)."""
    import torch
    from repro_torch.models.model import _XENT_CHUNK_BUDGET
    from repro_torch.models.transformer import GQA_KINDS, moe_layer_ids
    es = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    n, d, m = rows * seq, cfg.d_model, rows * (seq - 1)
    total = 0
    for kind in cfg.layer_kinds():
        if kind == "mla":
            total += n * (d + cfg.mla.kv_lora_rank
                          + cfg.mla.rope_head_dim) * es + n * d * 4
        elif kind in GQA_KINDS:
            total += n * d * es + n * d * 4
    if cfg.moe is not None:
        total += len(moe_layer_ids(cfg)) * (
            n * d * es + n * cfg.moe.top_k * 4 + n * d * 4)
    chunked = m * cfg.vocab_size > _XENT_CHUNK_BUDGET
    return total + n * d * 4 + m * d * es + 3 * 4 * m * (2 if chunked else 1)


def mesh_act_want(cfg, rows: int, seq: int, n_model: int) -> dict:
    """The activation sharding's bytes a rank exchanges over ``"model"``
    in one step of ``rows`` x ``seq`` tokens with every scanned group
    recomputed and the sequence on ``"model"`` between groups
    (``launch/shardctx``; ``"model"`` dividing the sequence, the heads
    and the experts): ``model_gathered`` the shards a group's start
    gathers (forward and recomputation), the tail's, and the gradient
    shards of each group's end and of the first group's start, (3
    groups + 2) shards of ``n_model - 1`` ranks in the model's dtype;
    ``model_scattered`` each MoE-ending group's float32 output, twice;
    ``reduced_delta`` what ``model_reduced_bytes`` gains over
    :func:`model_reduced_want` where every attention computes along
    ``"model"`` and every MoE layer ends its group: the recomputation
    repeats each group layer's attention exit (float32), and a MoE exit
    that ends a group is scattered in place of all-reduced."""
    import torch
    from repro_torch.models.transformer import _layer_is_moe, _layer_split
    es = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    n, d = rows * seq, cfg.d_model
    n_head, groups, _ = _layer_split(cfg)
    pat = len(cfg.block_pattern)
    moe_end = sum(_layer_is_moe(cfg, n_head + (g + 1) * pat - 1)
                  for g in range(groups))
    return {"model_gathered": (3 * groups + 2) * (n_model - 1)
            * (n // n_model) * d * es,
            "model_scattered": 2 * moe_end * n * d * 4,
            "reduced_delta": (groups * pat - moe_end) * n * d * 4}


def mesh_gathered_want(model, whole, mesh, remat: bool) -> int:
    """``gathered_bytes`` of one step: what a rank receives to gather
    each unit of ``whole`` (every sharded leaf as gathered, less its own
    shard), the embedding once (its backward pass reads no weight), each
    layer twice (for its backward pass; a recomputed group's layer but
    the last three times, as one unit is held at a time), the head once
    (its chunks' recomputation finds it held)."""
    import numpy as np
    from repro_torch.launch import sharding
    from repro_torch.models.transformer import _layer_split
    from repro_torch.training.optimizer import named_leaves
    named = named_leaves(whole)
    specs = {p: sharding.param_spec(p, t.shape, model.cfg, mesh)
             for p, t in named}
    along, path_of = sharding.model_computed(specs), {
        id(t): p for p, t in named}

    def received(unit):
        total = 0
        for _, t in named_leaves(unit):
            spec = specs[path_of[id(t)]]
            axes = [a for ax in spec if ax is not None
                    for a in (ax if isinstance(ax, tuple) else (ax,))]
            full = t.numel() * t.element_size()
            if axes:
                total += full // (mesh.shape["model"] if path_of[id(t)]
                                  in along else 1) - full // int(np.prod(
                                      [mesh.shape[a] for a in axes]))
        return total
    embed, *layers, head = model.units(whole)
    n_head, groups, _ = _layer_split(model.cfg)
    pat = len(model.cfg.block_pattern)
    third = {n_head + g * pat + j for g in range(groups)
             for j in range(pat - 1)} if remat else set()
    return received(embed) + received(head) + sum(
        (3 if i in third else 2) * received(u) for i, u in enumerate(layers))


def mesh_unit_shapes(cfg, n_model: int) -> dict:
    """The shapes a ``"model"`` rank computes with, gathered: this rank's
    vocabulary shard of ``tok_emb`` and of the head (``w`` of the head
    unit), and of a GQA model's query, KV and output head leaves."""
    d, v = cfg.d_model, cfg.vocab_size // n_model
    want = {"tok_emb": [v, d], "w": [d, v]}
    if cfg.mla is None:
        h, kvh = cfg.num_heads // n_model, cfg.num_kv_heads // n_model
        want.update({"attn/wq": [d, h, cfg.hd], "attn/wk": [d, kvh, cfg.hd],
                     "attn/wv": [d, kvh, cfg.hd], "attn/wo": [h, cfg.hd, d]})
    return want


def step_bytes(line: str) -> dict:
    """{"gathered", "reduce_scattered", "reduced", "model_reduced"}: the
    bytes of one of ``train``'s sharded step lines, by exchange."""
    inner = line.split("(", 2)[2].split(")")[0]
    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)B", inner)}


def mesh_train_rank(rank: int, world: int, rendezvous: str, out_dir: str,
                    c: dict, device: str, spawned_at: float) -> None:
    """One rank of the mesh_train phase, in a process of its own: a
    ``gloo`` group over ``file://`` rendezvous (NCCL refuses two ranks on
    one card), a 2x2 ``("data", "model")`` ``DeviceMesh`` on the card,
    then for each model of ``c["archs"]``
    ``launch.train.train(production_mesh=mesh)``: first its reduced
    config in float32 (its gathered parameters written by rank 0), then
    full width at 2 layers in bfloat16 with the launches, peak memory and
    the shapes of every gathered unit's leaves counted; a digest of every
    MoE layer's routed ids a step in each, the recomputation's too. A
    model of ``c["remat"]`` trains full width under
    ``shardctx.activation_sharding(c["act_spec"], remat=True)``, and its
    reduced config both without and with it. ``device`` is ``"cuda"``
    (``"cpu"`` rehearses the phase on the plain path). Writes its report
    to ``out_dir``: the first model's figures at its top, the others'
    under their names."""
    import contextlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import build, launch_counts, reset_launch_counts
    from repro_torch.launch import sharding, shardctx
    from repro_torch.launch.train import train
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import named_leaves

    routed, route = [], moe.route_train

    def route_digest(p, cfg, x):            # what the "model" ranks compare
        out = route(p, cfg, x)
        routed.append(hashlib.sha256(
            out[1].cpu().numpy().tobytes()).hexdigest())
        return out
    moe.route_train = route_digest
    shapes, unit = set(), shardctx.unit

    def unit_shapes(p):                     # the shapes the model computes with
        out = unit(p)
        shapes.update((k, tuple(t.shape)) for k, t in named_leaves(out))
        return out
    shardctx.unit = unit_shapes
    # seconds since the spawn at each step of the rank's start
    start = {"imported": time.time() - spawned_at}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    start["group"] = time.time() - spawned_at
    try:
        mesh = init_device_mesh(dev.type, c["mesh"],
                                mesh_dim_names=("data", "model"))
        start["mesh"] = time.time() - spawned_at
        if on_card:
            build.library()         # the parent's, from the build cache
        ready_s = time.time() - spawned_at
        run = dict(steps=c["steps"], batch_size=c["batch"],
                   seq_len=c["seq"], lr=CHECKPOINT["lr"], seed=SEED,
                   device=dev, production_mesh=mesh)

        def context(arch):
            if arch not in c["remat"]:
                return contextlib.nullcontext()
            return shardctx.activation_sharding(c["act_spec"], remat=True,
                                                mesh=mesh)

        def small_run(arch, name, ctx):
            rlines = []
            routed[:] = []
            with ctx:
                small, small_losses = train(get_reduced(arch),
                                            log=rlines.append, **run)
            steps = [ln for ln in rlines if ln.startswith("step ")]
            small = {k: sharding.full_tensor(t).cpu().numpy()
                     for k, t in named_leaves(small)}
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}_{arch}.npz"),
                         **small)
            return {"losses": small_losses, "first_line": rlines[0],
                    "gathered_peak_bytes_per_step": [
                        int(re.search(r"gathered_peak=(\d+)B",
                                      ln).group(1)) for ln in steps],
                    "largest_unit_bytes": int(re.search(
                        r"gathers at most (\d+) B", rlines[1]).group(1)),
                    "bytes_per_step": [step_bytes(ln) for ln in steps],
                    "routed": list(routed)}

        def model_run(arch):
            t_small = time.perf_counter()
            sm = small_run(arch, "small", contextlib.nullcontext())
            small_remat = (small_run(arch, "small_remat", context(arch))
                           if arch in c["remat"] else None)
            routed[:] = []
            small_s = time.perf_counter() - t_small
            cfg = get_config(arch).replace(num_layers=CHECKPOINT["layers"])
            want_params = want_moments = 0
            for path, t in named_leaves(build_model(cfg).init(
                    torch.Generator(dev).manual_seed(SEED), device="meta")):
                places = sharding.placements(
                    sharding.param_spec(path, t.shape, cfg, mesh), mesh)
                n = int(np.prod(shard_shape(t.shape, places, c["mesh"])))
                want_params += t.element_size() * n
                want_moments += 2 * 4 * n      # both moments, float32
            stamps = []

            def note(line):
                stamps.append((time.perf_counter(), line))

            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            reset_launch_counts()
            shapes.clear()
            t0 = time.perf_counter()
            with RssPeak() as rss, context(arch):
                params, losses = train(cfg, log=note, **run)
                if on_card:
                    torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = launch_counts()
            lines = [ln for _, ln in stamps]
            held = re.search(r"holds params (\d+) B of (\d+) B, moments "
                             r"(\d+) B, gathers at most (\d+) B", lines[1])
            step_at = [t for t, ln in stamps if ln.startswith("step ")]
            del params
            return {
                "small_s": small_s, "small_losses": sm["losses"],
                "small_first_line": sm["first_line"],
                "small_remat": small_remat, "losses": losses,
                "first_line": lines[0],
                "data_parallel": "batch=data-parallel" in lines[0],
                "param_bytes": int(held.group(1)),
                "whole_param_bytes": int(held.group(2)),
                "moment_bytes": int(held.group(3)),
                "want_param_bytes": want_params,
                "want_moment_bytes": want_moments,
                "exchanged_bytes_per_step": [
                    int(re.search(r"exchanged=(\d+)B", ln).group(1))
                    for ln in lines if ln.startswith("step ")],
                "gathered_peak_bytes_per_step": [
                    int(re.search(r"gathered_peak=(\d+)B", ln).group(1))
                    for ln in lines if ln.startswith("step ")],
                "bytes_per_step": [step_bytes(ln) for ln in lines
                                   if ln.startswith("step ")],
                "small_bytes_per_step": sm["bytes_per_step"],
                "routed": list(routed), "small_routed": sm["routed"],
                "largest_unit_bytes": int(held.group(4)),
                "small_gathered_peak_bytes_per_step":
                    sm["gathered_peak_bytes_per_step"],
                "small_largest_unit_bytes": sm["largest_unit_bytes"],
                "gathered_alive_after_bytes":
                    sharding.gathered_alive_bytes(),
                "unit_shapes": sorted([k, list(s)] for k, s in shapes),
                "s_per_step": [b - a for a, b in zip(
                    [stamps[1][0]] + step_at[:-1], step_at)],
                "train_s": train_s, "launches": launches,
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated() if on_card else None,
                "peak_rss_bytes": rss.peak}

        first, *rest = c["archs"]
        report = {"rank": rank, "coordinate": mesh.get_coordinate(),
                  "ready_s": ready_s, "start_s": start,
                  **model_run(first)}
        for arch in rest:
            report[arch] = model_run(arch)
        report["wall_s"] = time.time() - spawned_at
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def recomputed_as_routed(routed: list, n_moe: int) -> bool:
    """Whether each step's digests (``n_moe`` forward ones, then the
    recomputation's of the same layers, scanned one a group, in reverse)
    show the recomputation routing as its forward pass did."""
    steps = [routed[i:i + 2 * n_moe] for i in range(0, len(routed),
                                                     2 * n_moe)]
    return bool(steps) and all(len(st) == 2 * n_moe
                               and st[n_moe:] == st[:n_moe][::-1]
                               for st in steps)


def mesh_train_check(arch: str, reps: list, single: dict, c: dict,
                     want: dict) -> None:
    """Fail unless every rank's report ``reps`` of ``arch`` holds: the
    reduced float32 losses (of each layout run) within ``f32_tol`` of one
    device's and the full-width bfloat16 ones within ``BF16_LOSS_REL``;
    data-parallel rows; the parameter and moment bytes its placements
    give; the launches of ``want["launches"]``; every step's gathered
    peak equal to the largest unit as gathered (the log's bound and the
    specs' count), none alive after ``train``; every step's gathered and
    ``"model"`` bytes as ``want["bytes"]`` gives them; the vocabulary
    (and a GQA model's head) shards of :func:`mesh_unit_shapes` as the
    only shapes of those leaves; under the activation sharding
    (``want["remat"]``), the first lines naming it and every
    recomputation routing as its forward pass; and, where the model
    routes, the two ``"model"`` ranks of each data rank routing alike.
    ``single``: one device's losses; ``want``: the spec-derived
    counts."""
    tol = [BF16_LOSS_REL * abs(x) for x in single["losses"]]
    named = f"remat=True act_spec={tuple(c['act_spec'])}"
    for rep in reps:
        label = f"mesh_train: {arch} rank {rep['rank']}"
        smalls = [("small", rep["small_losses"], rep["small_first_line"])]
        if want["remat"]:
            sr = rep["small_remat"]
            smalls.append(("small_remat", sr["losses"], sr["first_line"]))
        for run, losses, first in smalls:
            err = max(abs(a - b) for a, b in zip(losses,
                                                 single["small_losses"]))
            if not err <= c["f32_tol"]:
                fail(f"{label}: {run} f32 losses {losses} against "
                     f"{single['small_losses']}")
            if "batch=data-parallel" not in first:
                fail(f"{label}: {run} did not run data-parallel: {first}")
        if not all(abs(a - b) <= t for a, b, t in zip(
                rep["losses"], single["losses"], tol)):
            fail(f"{label}: losses {rep['losses']} against "
                 f"{single['losses']}")
        if not rep["data_parallel"]:
            fail(f"{label}: did not run data-parallel: {rep['first_line']}")
        if want["remat"] and not (named in rep["first_line"]
                                  and named in smalls[1][2]):
            fail(f"{label}: did not run with {named}: {rep['first_line']}")
        if rep["param_bytes"] != rep["want_param_bytes"] \
                or rep["moment_bytes"] != rep["want_moment_bytes"]:
            fail(f"{label}: holds {rep['param_bytes']} B of parameters and "
                 f"{rep['moment_bytes']} B of moments, its placements give "
                 f"{rep['want_param_bytes']} and {rep['want_moment_bytes']}")
        launches = {k: want["launches"].get(k, 0) for k in rep["launches"]}
        if rep["launches"] != launches:
            fail(f"{label}: launches {rep['launches']}, want {launches}")
        runs = {"full": (rep["gathered_peak_bytes_per_step"],
                         rep["largest_unit_bytes"], rep["bytes_per_step"]),
                "small": (rep["small_gathered_peak_bytes_per_step"],
                          rep["small_largest_unit_bytes"],
                          rep["small_bytes_per_step"])}
        if want["remat"]:
            runs["small_remat"] = (sr["gathered_peak_bytes_per_step"],
                                   sr["largest_unit_bytes"],
                                   sr["bytes_per_step"])
        for run, (run_peak, bound, got) in runs.items():
            unit = want["unit"]["full" if run == "full" else "small"]
            if not bound == unit or run_peak != [bound] * c["steps"]:
                fail(f"{label}: held {run_peak} B gathered at once in the "
                     f"{run} run, the largest unit as gathered is {bound} B "
                     f"in the log, {unit} B by the specs")
            for key, n in want["bytes"][run].items():
                if [b[key] for b in got] != [n] * c["steps"]:
                    fail(f"{label}: {key} {[b[key] for b in got]} B in the "
                         f"{run} run, the shapes give {n} B a step")
        if rep["gathered_alive_after_bytes"] != 0:
            fail(f"{label}: {rep['gathered_alive_after_bytes']} B of "
                 "gathered weights alive after train returned")
        for path, shape in want["shapes"].items():
            got = [s for p, s in rep["unit_shapes"] if p == path]
            if got != [shape]:
                fail(f"{label}: computed with {path} of shapes {got}, this "
                     f"rank's shard is {shape}")
        if want["remat"]:
            for run, routed, n_moe in (
                    ("full", rep["routed"], want["moe_layers"]["full"]),
                    ("small_remat", sr["routed"],
                     want["moe_layers"]["small"])):
                if not recomputed_as_routed(routed, n_moe):
                    fail(f"{label}: the {run} run's recomputation routed "
                         f"apart from its forward pass ({len(routed)} "
                         "digests)")
    if not want["launches"]:                # no router: no ids to compare
        return
    keys = ("routed", "small_routed") + (
        ("small_remat_routed",) if want["remat"] else ())
    for rep in reps:           # the "model" ranks of a data rank route alike
        rep = rep | {"small_remat_routed": (rep["small_remat"] or {}).get(
            "routed")}
        for other in reps:
            if other["coordinate"][0] != rep["coordinate"][0]:
                continue
            other = other | {"small_remat_routed": (
                other["small_remat"] or {}).get("routed")}
            for key in keys:
                if not rep[key] or rep[key] != other[key]:
                    fail(f"mesh_train: {arch} ranks {rep['rank']} and "
                         f"{other['rank']} of one data rank routed apart "
                         f"({key}: {len(rep[key])} and {len(other[key])} "
                         "digests)")


def mesh_train_run(torch, np, dev):
    """``launch.train.train(production_mesh=)`` on ``MESH_TRAIN["ranks"]``
    spawned ranks sharing the card (``mesh_train_rank``), for
    DeepSeek-V2-Lite (MoE experts expert-parallel, MLA heads
    head-parallel) and internlm2-1.8b (GQA heads head-parallel), both
    with the embedding, head and loss vocabulary-parallel along
    ``"model"``, DeepSeek-V2-Lite under the reference's activation
    sharding (``shardctx.activation_sharding(MESH_TRAIN["act_spec"],
    remat=True)``: its scanned groups recomputed, the sequence on
    ``"model"`` between them; its reduced run also without it), against
    the same 2 steps on one device from the same seed and batches
    (``train`` without a mesh, i.e. ``train_step``), run first by this
    process and freed before the spawn. Fails if a rank raises, dies or
    outlasts ``timeout_s`` (every rank is stopped then), unless, for
    each model (:func:`mesh_train_check`): each reduced float32 run's
    losses and gathered parameters are within ``f32_tol`` of the
    single-device run's; the full-width bfloat16 losses of every rank
    are within ``BF16_LOSS_REL`` of the single-device ones and ran
    data-parallel, under the activation sharding where asked (the first
    lines name it); each rank holds the parameter and float32 moment
    bytes its placements give; the sum over ranks is the whole tree's
    bytes times each leaf's replication; ``topk_gating`` launched exactly
    once per MoE layer and step on each rank, and once more per
    recomputed one (DeepSeek-V2-Lite; internlm2 launches no kernel);
    every recomputation routed as its forward pass, and the two
    ``"model"`` ranks of each data rank alike (every MoE layer and step,
    every run); every step's gathered peak equals the largest unit as
    gathered (``train``'s log, and ``unit_gathered_bytes`` of the specs
    here), none alive once ``train`` returned; every step's
    ``gathered_bytes`` is :func:`mesh_gathered_want`,
    ``model_reduced_bytes`` :func:`model_reduced_want` (plus
    :func:`mesh_act_want`'s delta) and ``model_gathered_bytes`` and
    ``model_scattered_bytes`` :func:`mesh_act_want`'s (0 without the
    context); each rank computed with its vocabulary shard of
    ``tok_emb`` and the head and internlm2 with its query and KV head
    shards (:func:`mesh_unit_shapes`); and each rank's peak device
    memory is below ``PER_LAYER_MESH_PEAK_BYTES``, DeepSeek-V2-Lite's
    below ``VOCAB_PARALLEL_MESH_PEAK_BYTES``."""
    import tempfile
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch import sharding
    from repro_torch.launch.train import train, unit_gathered_bytes
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import moe_layer_ids
    from repro_torch.training.optimizer import named_leaves

    c = MESH_TRAIN
    world = c["ranks"]
    run = dict(steps=c["steps"], batch_size=c["batch"], seq_len=c["seq"],
               lr=CHECKPOINT["lr"], seed=SEED, device=dev, log=lambda s: None)

    class Mesh:                 # the rules' stand-in: names and sizes
        axis_names = ("data", "model")
        shape = dict(zip(axis_names, c["mesh"]))
    rows = c["batch"] // c["mesh"][0]
    single, want, replicated = {}, {}, {}
    t0 = time.perf_counter()
    for arch in c["archs"]:
        small_cfg = get_reduced(arch)
        small, small_losses = train(small_cfg, **run)
        cfg = get_config(arch).replace(num_layers=CHECKPOINT["layers"])
        torch.cuda.reset_peak_memory_stats()
        params, losses = train(cfg, **run)
        single[arch] = {
            "cfg": cfg, "losses": losses, "small_losses": small_losses,
            "small": {k: t.detach().cpu().numpy()
                      for k, t in named_leaves(small)},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        del small, params
        release_host_memory(torch)
        meta = build_model(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     device="meta")
        small_meta = build_model(small_cfg).init(
            torch.Generator(dev).manual_seed(SEED), device="meta")
        n_moe = len(moe_layer_ids(cfg))
        remat = arch in c["remat"]
        n_model = Mesh.shape["model"]

        def step_want(run_cfg, whole, on):
            act = (mesh_act_want(run_cfg, rows, c["seq"], n_model) if on
                   else dict.fromkeys(("model_gathered", "model_scattered",
                                       "reduced_delta"), 0))
            return {"gathered": mesh_gathered_want(
                        build_model(run_cfg), whole, Mesh, on),
                    "model_reduced": model_reduced_want(
                        run_cfg, rows, c["seq"]) + act["reduced_delta"],
                    "model_gathered": act["model_gathered"],
                    "model_scattered": act["model_scattered"]}
        want[arch] = {
            "unit": {"full": max(unit_gathered_bytes(build_model(cfg), meta,
                                                     Mesh)),
                     "small": max(unit_gathered_bytes(
                         build_model(small_cfg), small_meta, Mesh))},
            "bytes": {"full": step_want(cfg, meta, remat),
                      "small": step_want(small_cfg, small_meta, False)},
            # the scanned MoE layers route again in the recomputation
            "launches": {"topk_gating": (n_moe + n_moe * remat)
                         * c["steps"]} if n_moe else {},
            "moe_layers": {"full": n_moe,
                           "small": len(moe_layer_ids(small_cfg))},
            "remat": remat,
            "shapes": mesh_unit_shapes(cfg, n_model)}
        if remat:
            want[arch]["bytes"]["small_remat"] = step_want(
                small_cfg, small_meta, True)
        replicated[arch] = 0    # sum over ranks: bytes x replication
        for path, t in named_leaves(meta):
            spec = sharding.param_spec(path, t.shape, cfg, Mesh)
            used = {a for ax in spec if ax is not None
                    for a in (ax if isinstance(ax, tuple) else (ax,))}
            rep = int(np.prod([n for a, n in Mesh.shape.items()
                               if a not in used]))
            replicated[arch] += rep * t.numel() * t.element_size()
    single_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            mesh_train_rank, args=(world, os.path.join(tmp, "rendezvous"),
                                   tmp, c, dev.type, time.time()),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + c["timeout_s"]
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    fail(f"mesh_train: the ranks did not finish within "
                         f"{c['timeout_s']} s")
        except ProcessException as exc:
            fail(f"mesh_train: rank {exc.error_index} failed: {exc}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        spawn_to_done_s = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(world)]
        gathered = {(name, arch): dict(np.load(os.path.join(
            tmp, f"{name}_{arch}.npz"))) for arch in c["archs"]
            for name in ("small", "small_remat")
            if name == "small" or arch in c["remat"]}
    first = c["archs"][0]
    by_arch = {arch: [rep if arch == first else rep[arch] | {
        "rank": rep["rank"], "coordinate": rep["coordinate"]}
        for rep in ranks] for arch in c["archs"]}
    small_err = {}
    for (name, arch), tree in gathered.items():
        small = single[arch]["small"]
        if sorted(tree) != sorted(small):
            fail(f"mesh_train: the gathered {name} {arch} tree's keys "
                 "differ")
        small_err[name, arch] = max(float(np.abs(tree[k] - v).max())
                                    for k, v in small.items())
        if not small_err[name, arch] <= c["f32_tol"]:
            fail(f"mesh_train: {name} f32 {arch} parameters differ by "
                 f"{small_err[name, arch]}")
    for arch in c["archs"]:
        mesh_train_check(arch, by_arch[arch], single[arch], c, want[arch])
        held = sum(rep["param_bytes"] for rep in by_arch[arch])
        if held != replicated[arch]:
            fail(f"mesh_train: the ranks hold {held} B of {arch}'s "
                 "parameters, the whole tree times each leaf's replication "
                 f"is {replicated[arch]} B")
        for rep in by_arch[arch]:
            peak = rep["max_memory_allocated_bytes"]
            bound = (VOCAB_PARALLEL_MESH_PEAK_BYTES if arch in c["remat"]
                     else MODEL_PARALLEL_MESH_PEAK_BYTES if arch == first
                     else PER_LAYER_MESH_PEAK_BYTES)
            if peak is not None and not peak < bound:
                fail(f"mesh_train: {arch} rank {rep['rank']}: peak device "
                     f"memory {peak} B, not below {bound} B")
    launches = {k: sum(rep["launches"][k] + sum(
        rep[arch]["launches"][k] for arch in c["archs"][1:])
        for rep in ranks) for k in ranks[0]["launches"]}

    def figures(arch):
        reps, s = by_arch[arch], single[arch]
        return {
            "config": s["cfg"].name, "dtype": s["cfg"].dtype,
            "layers": s["cfg"].num_layers,
            "data_parallel": all(rep["data_parallel"] for rep in reps),
            "single_losses": s["losses"],
            "rank_losses": [rep["losses"] for rep in reps],
            "max_loss_diff": max(abs(a - b) for rep in reps
                                 for a, b in zip(rep["losses"],
                                                 s["losses"])),
            "small_single_losses": s["small_losses"],
            "small_max_loss_diff": max(
                abs(a - b) for rep in reps
                for a, b in zip(rep["small_losses"], s["small_losses"])),
            "small_max_param_diff": small_err["small", arch],
            "remat": arch in c["remat"],
            "first_line": reps[0]["first_line"],
            "small_remat_max_loss_diff": max(
                abs(a - b) for rep in reps for a, b in zip(
                    rep["small_remat"]["losses"], s["small_losses"]))
            if arch in c["remat"] else None,
            "small_remat_max_param_diff": small_err.get(("small_remat",
                                                         arch)),
            "small_remat_bytes_per_step": [
                rep["small_remat"]["bytes_per_step"] for rep in reps]
            if arch in c["remat"] else None,
            "single_max_memory_allocated_bytes":
                s["max_memory_allocated_bytes"],
            "rank_small_s": [rep["small_s"] for rep in reps],
            "rank_train_s": [rep["train_s"] for rep in reps],
            "s_per_step": [rep["s_per_step"] for rep in reps],
            "exchanged_bytes_per_step": [rep["exchanged_bytes_per_step"]
                                         for rep in reps],
            "gathered_peak_bytes_per_step": [
                rep["gathered_peak_bytes_per_step"] for rep in reps],
            "bytes_per_step": [rep["bytes_per_step"] for rep in reps],
            "bytes_want": want[arch]["bytes"],
            "routed_digests_per_rank": len(reps[0]["routed"]),
            "largest_unit_bytes": reps[0]["largest_unit_bytes"],
            "largest_unit_want": want[arch]["unit"]["full"],
            "unit_shapes_want": want[arch]["shapes"],
            "gathered_alive_after_bytes": [
                rep["gathered_alive_after_bytes"] for rep in reps],
            "whole_param_bytes": reps[0]["whole_param_bytes"],
            "rank_param_bytes": [rep["param_bytes"] for rep in reps],
            "rank_moment_bytes": [rep["moment_bytes"] for rep in reps],
            "sum_param_bytes": sum(rep["param_bytes"] for rep in reps),
            "replicated_param_bytes": replicated[arch],
            "max_memory_allocated_bytes": [
                rep["max_memory_allocated_bytes"] for rep in reps],
            "rank_peak_rss_bytes": [rep["peak_rss_bytes"] for rep in reps],
            "launches_per_rank": [rep["launches"].get("topk_gating", 0)
                                  for rep in reps]}

    result = {
        **figures(first),
        **{arch: figures(arch) for arch in c["archs"][1:]},
        "moe_layers": len(moe_layer_ids(single[first]["cfg"])),
        "ranks": world, "backend": "gloo",
        "mesh": dict(zip(Mesh.axis_names, c["mesh"])),
        **{k: c[k] for k in ("batch", "seq", "steps", "timeout_s",
                             "f32_tol")},
        "lr": CHECKPOINT["lr"], "bf16_loss_rel_tol": BF16_LOSS_REL,
        "single_device_s": single_s,
        "spawn_to_done_s": spawn_to_done_s,
        "rank_ready_s": [rep["ready_s"] for rep in ranks],
        "rank_start_s": [rep["start_s"] for rep in ranks],
        "rank_wall_s": [rep["wall_s"] for rep in ranks],
        "whole_tree_mesh_peak_bytes": WHOLE_TREE_MESH_PEAK_BYTES,
        "per_layer_mesh_peak_bytes": PER_LAYER_MESH_PEAK_BYTES,
        "model_parallel_mesh_peak_bytes": MODEL_PARALLEL_MESH_PEAK_BYTES,
        "vocab_parallel_mesh_peak_bytes": VOCAB_PARALLEL_MESH_PEAK_BYTES,
        "act_spec": list(c["act_spec"])}
    return result, launches


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
# 10% cache. Batch 1 serves the first 2 of the 8 held-out prompts (4
# until the phase took 175.8 s on a slow host, 3 until the script took
# 1,232 s there): on an H100 80GB HBM3
# (700 W) the batch-1 engine runs ~55 positions/s on this backbone (~23
# with the learned policy's 7 predictor forwards a step), so all 8 would
# take ~250 s
SERVE = dict(layer_compute_s=50e-6, max_batch=4, block_size=8,
             prefill_chunk=8, batch1_prompts=2)
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
    chunk, so the chunked ring wraps twice in a 34-position request and
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
    # 4 new tokens (8 until the checkpoint and dispatch phases needed the
    # time): the 30-token prompt's ring still wraps at 16 and 32
    max_new, cache_len, capacity, layer_s = 4, 48, 4, 2e-4
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


def greedy(torch, model, params, batch, steps: int, cache_len=None):
    """Facade prefill of ``batch`` (its ``tokens`` (B, T), and a vision
    config's ``patches``), then ``steps`` greedy decode steps on the
    batch's device, nothing read back to the host until the end;
    ``cache_len`` defaults to T + steps. Returns (tokens (B, steps), the
    last-position logits of the prefill and of every step (steps + 1, B,
    V), final state, prefill seconds, decode seconds)."""
    if cache_len is None:
        cache_len = batch["tokens"].shape[1] + steps
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, state = model.prefill(params, batch, cache_len)
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
    return (torch.stack(toks, 1), torch.stack(outs), state, prefill_s,
            decode_s)


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
        greedy(torch, model, params, {"tokens": prompts}, 2)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        toks, outs, state, prefill_s, decode_s = greedy(
            torch, model, params, {"tokens": prompts}, steps)
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
            "launches": launches, "stream_head": toks[:, :8].tolist()}
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
        toks, outs, _, _, _ = greedy(torch, model, p,
                                     {"tokens": prompts.to(d)}, steps)
        if not torch.isfinite(outs).all():
            fail(f"parity run 3: non-finite logits on the {where}")
        runs[where] = (toks.tolist(), outs.cpu())
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


# ---------------------------------------------------------------------------
# phases 9-11: the GQA modes, the vision prefix and the dense GQA decoders

GQA_ARCHS = ("yi-6b", "internlm2-1.8b", "phi3-mini-3.8b", "gemma3-27b",
             "pixtral-12b", "llama4-scout-17b-a16e")
# parity_gqa: prompts of PARITY_GQA_TEXT tokens (after the reduced vision
# prefix of 16 patches: past Scout's 64-slot chunk and gemma3's 32-slot
# window), greedy steps; Scout's trace; the global-only Scout stack
PARITY_GQA_TEXT, PARITY_GQA_STEPS, PARITY_GQA_TOL = 52, 8, 1e-4
# facade_scout: Llama-4-Scout at full width, 4 of 48 layers (one 3:1
# chunked:global group), every expert on the card, drop-free capacity so
# the full-mode forward and the decode steps route alike
FACADE_SCOUT = dict(layers=4, batch=2, patches=256, prompt=64, cache_len=512,
                    steps=32, compared=8, trace_prompt=64, trace_new=32)
# facade_gemma3: gemma3-27b at full width, 6 of 62 layers (one 5 local : 1
# global group); the 1,100-token prompt wraps the 1,024-slot local ring
FACADE_GEMMA3 = dict(layers=6, batch=1, prompt=1100, cache_len=1200,
                     steps=32, compared=8)

# phases 12-14: the RG-LRU block and the encoder-decoder with
# cross-attention. facade_recurrentgemma: recurrentgemma-9b at full width,
# 6 of 38 layers (two rglru, rglru, local groups); the 2,100-token prompt
# wraps the 2,048-slot local ring
FACADE_RECURRENTGEMMA = dict(layers=6, batch=2, prompt=2100, cache_len=2132,
                             steps=32, compared=8)
# facade_seamless: seamless-m4t-large-v2 at full width and depth (24
# encoder and 24 decoder layers), 512 audio frames of width 1,024 a prompt
FACADE_SEAMLESS = dict(layers=24, batch=2, frames=512, prompt=16,
                       cache_len=48, steps=32, compared=8)
# parity_recurrent: both reduced configs, prompts of PARITY_RECURRENT_TEXT
# tokens (past recurrentgemma's 32-slot window), greedy steps
RECURRENT_ARCHS = ("recurrentgemma-9b", "seamless-m4t-large-v2")
PARITY_RECURRENT_TEXT, PARITY_RECURRENT_STEPS, PARITY_RECURRENT_TOL = \
    52, 8, 1e-4


def facade_against_forward(torch, model, params, batch, toks, outs,
                           compared, label):
    """Max abs differences of the prefill's last logits and the first
    ``compared`` decode steps' logits from ``Model.forward`` on the fused
    sequence (prompt, then the tokens those steps were fed)."""
    text = torch.cat([batch["tokens"], toks[:, :compared]], 1)
    fwd = model.forward(params, {**batch, "tokens": text})
    n = fwd.shape[1] - compared          # the prompt's last position + 1
    want = fwd[:, n - 1:].transpose(0, 1)                  # (compared+1,B,V)
    if not torch.isfinite(fwd).all():
        fail(f"{label}: non-finite forward logits")
    diff = (outs[:compared + 1].float() - want.float()).abs()
    return {"prefill_max_abs_diff": diff[0].max().item(),
            "decode_max_abs_diff": diff[1:].amax(dim=(1, 2)).tolist(),
            "logit_abs_max": want.abs().max().item(),
            "greedy_agrees_with_forward": (
                want[:-1].argmax(-1).T == toks[:, :compared]).float()
            .mean().item()}


def facade_run(torch, np, dev, label, cfg, c, modality=None, trace=None):
    """Seeded weights on the card at ``cfg``'s full width, then
    ``c["batch"]`` prompts through ``greedy``, compared with ``forward``;
    ``modality`` maps a batch key (``"patches"``: a vision prefix before
    the prompt; ``"frames"``: an encoder-decoder's audio frames) to its
    width, ``c[key]`` random rows of it a prompt. Launches are counted
    over prefill and decode (``want``, per kernel: ``flash_decode`` once
    an attention layer and step, twice a decoder layer of an
    encoder-decoder, for its self- and cross-attention), then over
    ``trace`` = (prompt length, new tokens) through ``collect_trace`` at
    batch 1. An encoder-decoder's encoder is also timed alone
    (``encoder_s``). Fails on non-finite logits, a decode position off
    the fused length or a launch count off its expected value."""
    from repro_torch.configs import get_config
    from repro_torch.core.tracing import collect_trace, moe_layer_ids
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import encdec
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED + 43),
                        device=dev)
    init_s = since(torch, t0)
    param_bytes = sum(t.numel() * t.element_size() for t in tensors(params))
    gen = torch.Generator(dev).manual_seed(SEED + 44)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (c["batch"], c["prompt"]),
                                     generator=gen, device=dev)}
    for key, width in (modality or {}).items():
        batch[key] = torch.randn(c["batch"], c[key], width, generator=gen,
                                 device=dev)
    n_prefix = c["patches"] if "patches" in batch else 0
    greedy(torch, model, params, batch, 2, c["cache_len"])   # warm-up
    reset_launch_counts()
    toks, outs, state, prefill_s, decode_s = greedy(
        torch, model, params, batch, c["steps"], c["cache_len"])
    launches = launch_counts()
    if not torch.isfinite(outs).all():
        fail(f"{label}: non-finite logits")
    if state["pos"] != n_prefix + c["prompt"] + c["steps"]:
        fail(f"{label}: decode state at {state['pos']}")
    n_moe = len(moe_layer_ids(cfg)) if cfg.moe else 0
    want = {k: 0 for k in launches}
    want["flash_decode"] = c["steps"] * (
        2 * cfg.num_layers if cfg.encdec is not None
        else sum(k not in ("rglru", "ssd") for k in cfg.layer_kinds()))
    if n_moe:   # the prefill's router once a MoE layer, decode's each step
        want["expert_ffn"] = n_moe * c["steps"]
        want["topk_gating"] = n_moe * (c["steps"] + 1)
    if launches != want:
        fail(f"{label}: launches {launches}, want {want}")
    vs_forward = facade_against_forward(torch, model, params, batch, toks,
                                        outs, c["compared"], label)
    result = {"config": cfg.name, "dtype": cfg.dtype,
              "layers": cfg.num_layers,
              "full_depth": get_config(cfg.name).num_layers,
              "params": sum(t.numel() for t in tensors(params)),
              "param_bytes_on_device": param_bytes, "init_s": init_s,
              **c, "n_prefix": n_prefix, "prefill_s": prefill_s,
              "prefill_tokens_per_s": c["batch"] * (n_prefix + c["prompt"])
              / prefill_s, "decode_s": decode_s,
              "decode_ms_per_step": decode_s / c["steps"] * 1e3,
              "decode_tokens_per_s": c["batch"] * c["steps"] / decode_s,
              "launches": launches, "vs_forward": vs_forward,
              "stream_head": toks[:, :8].tolist()}
    if cfg.encdec is not None:
        t0 = time.perf_counter()
        encdec.encoder_apply(params["encoder"], cfg, batch["frames"])
        result["encoder_s"] = since(torch, t0)
    if trace is not None:
        plen, new = trace
        prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=gen,
                               device=dev).tolist()
        reset_launch_counts()
        t0 = time.perf_counter()
        tr = collect_trace(model, params, prompt, new, plen + new, 0.0)
        trace_s = since(torch, t0)
        tl = launch_counts()
        steps = plen + new
        tw = {k: 0 for k in tl}
        tw["flash_decode"] = cfg.num_layers * steps
        tw["expert_ffn"] = tw["topk_gating"] = n_moe * steps
        if tl != tw:
            fail(f"{label}: trace launches {tl}, want {tw}")
        if (tr.experts.shape != (steps, n_moe, cfg.moe.top_k)
                or not ((0 <= tr.experts)
                        & (tr.experts < cfg.moe.num_experts)).all()):
            fail(f"{label}: a malformed trace")
        result.update(trace_steps=steps, trace_s=trace_s,
                      trace_steps_per_s=steps / trace_s, trace_launches=tl,
                      trace_experts_head=tr.experts[:4, :, 0].tolist())
        launches = {k: launches[k] + tl[k] for k in launches}
    result["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del params, outs, state
    return result, launches


def facade_scout_run(torch, np, dev):
    """Phase 9: Llama-4-Scout through the facade at full width, bfloat16,
    ``FACADE_SCOUT``: prefill of 256 patches (width 1,408) and a 64-token
    prompt at B 2, 32 greedy decode steps (``flash_decode`` on the
    8,192-slot chunked rings and the global rows, ``topk_gating`` and
    ``expert_ffn`` over the (E, D, F) experts on the card), compared with
    ``forward`` on the fused sequence; then ``collect_trace`` of one
    64-token prompt with 32 new tokens at batch 1."""
    import dataclasses

    from repro_torch.configs import get_config

    c = FACADE_SCOUT
    cfg = get_config(LLAMA4)
    moe = dataclasses.replace(cfg.moe,
                              capacity_factor=float(cfg.moe.num_experts))
    cfg = cfg.replace(num_layers=c["layers"], moe=moe)
    result, launches = facade_run(
        torch, np, dev, "facade_scout", cfg, c,
        modality={"patches": cfg.frontend_dim},
        trace=(c["trace_prompt"], c["trace_new"]))
    result["capacity_factor"] = moe.capacity_factor
    return result, launches


def facade_gemma3_run(torch, np, dev):
    """Phase 10: gemma3-27b through the facade at full width, bfloat16,
    ``FACADE_GEMMA3``: a 1,100-token prompt (the 1,024-slot local ring
    wraps) and 32 greedy decode steps, compared with ``forward``."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-27b").replace(
        num_layers=FACADE_GEMMA3["layers"])
    return facade_run(torch, np, dev, "facade_gemma3", cfg, FACADE_GEMMA3)


def facade_card_vs_cpu(torch, dev, label, model, params, batch, steps,
                       cache_len, tol):
    """``greedy`` of ``batch`` (CPU tensors) with ``params`` (drawn for
    the CPU) on the card, then on the CPU; fails unless the streams and
    final positions are identical and the logits agree within ``tol``.
    Returns (the stream, the max abs logit difference, the final
    position, the card run's launches)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    runs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        reset_launch_counts()
        toks, outs, state, _, _ = greedy(
            torch, model, to_device(params, d),
            {k: v.to(d) for k, v in batch.items()}, steps, cache_len)
        runs[where] = (toks.tolist(), outs.cpu(), state["pos"],
                       launch_counts())
    if runs["card"][0] != runs["cpu"][0] or runs["card"][2] != runs["cpu"][2]:
        fail(f"{label}: GPU/CPU streams differ: {runs['card'][0]} vs "
             f"{runs['cpu'][0]}")
    err = (runs["card"][1] - runs["cpu"][1]).abs().max().item()
    if not err <= tol:
        fail(f"{label}: logits differ by {err} > {tol}")
    return runs["card"][0], err, runs["card"][2], runs["card"][3]


def parity_run_gqa(torch, np, dev):
    """Phase 11: the slice's paths on reduced configs in float32 (TF32
    off), card against CPU from weights drawn on the card: each of
    ``GQA_ARCHS`` through ``prefill`` (with patches for a vision config)
    and ``PARITY_GQA_STEPS`` greedy ``decode_step``s; ``collect_trace`` of
    the reduced Llama-4-Scout; and Scout cut to global layers through the
    paged ``BatchedOffloadEngine`` with chunked prefill, the prefix index
    off and on. Identical streams, routed ids and ``EngineStats``; logits
    within ``PARITY_GQA_TOL``; on the card ``paged_flash_decode`` launched
    in the chunks and ``flash_decode`` in the facade."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.policies import NextLayerAllPolicy
    from repro_torch.core.tracing import collect_trace
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.scheduler import BatchedOffloadEngine

    cpu = torch.device("cpu")
    out = {"facade": {}, "engine": {}}
    card_launches = {}
    errs = []
    for i, arch in enumerate(GQA_ARCHS):
        cfg = get_reduced(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator(dev).manual_seed(SEED + 50 + i),
                            device="cpu")             # drawn on the card
        gen = torch.Generator().manual_seed(SEED + 50 + i)
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (2, PARITY_GQA_TEXT), generator=gen)}
        n_prefix = cfg.frontend_len if cfg.frontend == "vision" else 0
        if n_prefix:
            batch["patches"] = torch.randn(2, n_prefix, cfg.frontend_dim,
                                           generator=gen)
        stream, err, pos, lc = facade_card_vs_cpu(
            torch, dev, f"parity_gqa {arch}", model, params, batch,
            PARITY_GQA_STEPS,
            n_prefix + PARITY_GQA_TEXT + PARITY_GQA_STEPS + 1, PARITY_GQA_TOL)
        for k, v in lc.items():
            card_launches[k] = card_launches.get(k, 0) + v
        errs.append(err)
        out["facade"][arch] = {"max_abs_logit_err": err, "pos": pos,
                               "stream_head": stream[0][:4]}

    cfg = get_reduced(LLAMA4)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 56),
                        device="cpu")
    prompt = np.random.default_rng(SEED + 56).integers(
        0, cfg.vocab_size, 60).tolist()
    traces = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        tr = collect_trace(model, to_device(params, d), prompt, 8, 72, 0.0)
        traces[where] = (tr.tokens.tolist(), tr.experts.tolist())
    if traces["card"] != traces["cpu"]:
        fail("parity_gqa: Scout's GPU/CPU traces differ")
    out["trace"] = {"tokens": len(traces["card"][0]), "identical": True}

    cfg = get_reduced(LLAMA4).replace(block_pattern=("global",),
                                      frontend=None)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 57),
                        device="cpu")
    rng = np.random.default_rng(SEED + 57)
    system = rng.integers(0, cfg.vocab_size, 9).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (4, 1, 6)] + [rng.integers(0, cfg.vocab_size,
                                                   5).tolist()]
    for prefix in (False, True):
        runs = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            reset_launch_counts()
            eng = BatchedOffloadEngine(
                model, params, NextLayerAllPolicy(cfg.moe.num_experts),
                2 * cfg.moe.num_experts, host_bw=PARITY_HOST_BW,
                serve=ServeConfig(max_batch=3, block_size=4,
                                  prefix_cache=prefix), device=d)
            routes = record_routes(eng.core, check_finite=True)
            outs = eng.generate(prompts, 6, 32)
            st = eng.stats.as_dict()
            st.pop("latency")
            runs[where] = (outs, routes, st)
            if where == "card":
                lc = launch_counts()
                if lc["paged_flash_decode"] == 0 or lc["flash_decode"]:
                    fail(f"parity_gqa engine: card launches {lc}")
                for k, v in lc.items():
                    card_launches[k] = card_launches.get(k, 0) + v
            if prefix and not (eng.prefix.stats.hits
                               + eng.prefix.stats.extensions):
                fail("parity_gqa engine: the prefix index matched nothing")
            if prefix:
                st["prefix"] = eng.prefix.stats.as_dict()
            del eng
        check_same(f"parity_gqa engine (prefix {prefix}): ", runs["card"],
                   runs["cpu"])
        if not runs["card"][2]["prefill_chunks"]:
            fail("parity_gqa engine: no prefill chunk")
        out["engine"][f"prefix_{'on' if prefix else 'off'}"] = {
            "streams": runs["card"][0], "stats": runs["card"][2]}
    for name in ("flash_decode", "paged_flash_decode", "expert_ffn",
                 "topk_gating"):
        if not card_launches.get(name):
            fail(f"parity_gqa never launched the {name} kernel")
    out.update(identical=True, max_abs_logit_err=max(errs),
               tolerance=PARITY_GQA_TOL, card_launches=card_launches)
    return out


def facade_recurrentgemma_run(torch, np, dev):
    """Phase 12: recurrentgemma-9b through the facade at full width,
    bfloat16, ``FACADE_RECURRENTGEMMA``: 2 prompts of 2,100 tokens (the
    RG-LRU blocks' log-depth scan, the 2,048-slot local ring wraps) and
    32 greedy decode steps (``flash_decode`` on the two local layers,
    hd 256 over one kv head; the RG-LRU's O(1) step), compared with
    ``forward``."""
    from repro_torch.configs import get_config

    cfg = get_config("recurrentgemma-9b").replace(
        num_layers=FACADE_RECURRENTGEMMA["layers"])
    return facade_run(torch, np, dev, "facade_recurrentgemma", cfg,
                      FACADE_RECURRENTGEMMA)


def facade_seamless_run(torch, np, dev):
    """Phase 13: seamless-m4t-large-v2 through the facade at full width
    and depth, bfloat16, ``FACADE_SEAMLESS``: 512 seeded audio frames and
    a 16-token prompt at B 2 (the bidirectional encoder, the cross
    memory, the decoder's prefill), then 32 greedy decode steps, each
    decoder layer's self-attention and cross-attention through
    ``flash_decode``; compared with ``forward``."""
    from repro_torch.configs import get_config

    cfg = get_config("seamless-m4t-large-v2")
    return facade_run(torch, np, dev, "facade_seamless", cfg,
                      FACADE_SEAMLESS, modality={"frames": cfg.frontend_dim})


def parity_run_recurrent(torch, np, dev):
    """Phase 14: the reduced recurrentgemma-9b and seamless-m4t-large-v2
    in float32 (TF32 off), card against CPU from weights drawn on the
    card: ``prefill`` of 2 prompts of ``PARITY_RECURRENT_TEXT`` tokens
    (with the config's frames for seamless) and
    ``PARITY_RECURRENT_STEPS`` greedy ``decode_step``s. Identical
    streams, logits within ``PARITY_RECURRENT_TOL``; the card's decode
    through ``flash_decode`` (once a local layer and step; twice a
    seamless decoder layer and step), the CPU's through its plain
    version."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import build_model

    out, errs = {}, []
    steps, text = PARITY_RECURRENT_STEPS, PARITY_RECURRENT_TEXT
    for i, arch in enumerate(RECURRENT_ARCHS):
        cfg = get_reduced(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator(dev).manual_seed(SEED + 62 + i),
                            device="cpu")             # drawn on the card
        gen = torch.Generator().manual_seed(SEED + 62 + i)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, text),
                                         generator=gen)}
        if cfg.encdec is not None:
            batch["frames"] = torch.randn(2, cfg.frontend_len,
                                          cfg.frontend_dim, generator=gen)
        stream, err, pos, lc = facade_card_vs_cpu(
            torch, dev, f"parity_recurrent {arch}", model, params, batch,
            steps, text + steps + 1, PARITY_RECURRENT_TOL)
        want = steps * (2 * cfg.num_layers if cfg.encdec is not None else
                        sum(k == "local" for k in cfg.layer_kinds()))
        if lc["flash_decode"] != want or any(
                v for k, v in lc.items() if k != "flash_decode"):
            fail(f"parity_recurrent {arch}: card launches {lc}, want "
                 f"{want} flash_decode")
        errs.append(err)
        out[arch] = {"max_abs_logit_err": err, "pos": pos,
                     "card_launches": lc, "stream_head": stream[0][:4]}
    out.update(identical=True, max_abs_logit_err=max(errs),
               tolerance=PARITY_RECURRENT_TOL)
    return out


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
    if sys.flags.optimize:
        fail("python -O strips the assert statements that the leak "
             "sanitizer's ledger checks are made of: run without -O")
    sys.path.insert(0, str(SRC))
    from repro_torch.analysis import RetraceGuard

    # one guard for the whole process: it sees the kernel library load and
    # phase 2's graph captures, then freezes every later phase
    with RetraceGuard() as guard:
        run(torch, guard)


def probe_guard(torch, dev, guard) -> dict:
    """The guard's own checks on this card's PyTorch: it saw the library
    load and phase 2's graph captures, and a trivial capture inside
    ``frozen`` raises ``RetraceError``."""
    from repro_torch.analysis import RetraceError

    guard.self_check()
    seen = guard.by_source()
    if not seen["kernel_library"] or not seen["cuda_graph"]:
        fail(f"the retrace guard missed the library load or phase 2's "
             f"graph captures: {seen}")
    x = torch.zeros(1, device=dev)
    try:
        with guard.frozen("probe"):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                x.add_(1.0)
            torch.cuda.synchronize()
    except RetraceError as e:
        return {"self_check": "passed", "probe_raised": str(e)}
    fail("a graph captured inside the retrace guard's frozen region did "
         "not raise RetraceError: the capture hook is not wired")


def run(torch, guard) -> None:
    """Every phase (the module docstring's list), under ``guard``."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.analysis import RetraceError
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
    retrace = probe_guard(torch, dev, guard)
    log(f"retrace guard: {retrace['probe_raised']}")

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
        ("main_run", ds,
         lambda: main_run(torch, np, dev, ds, host_bw, keep=keep), ds),
        ("serve_telemetry", ds,
         lambda: serve_telemetry_run(torch, np, dev, host_bw, keep[ds],
                                     (runs["main_run"], launches[ds])),
         "serve_telemetry"),
        ("parity_workload", ds, lambda: parity_run_workload(torch, np, dev),
         None),
        ("serve_workload", ds,
         lambda: serve_workload_run(torch, np, dev, host_bw, keep[ds]),
         "serve_workload"),
        ("parity_tiers", ds, lambda: parity_run_tiers(torch, np, dev), None),
        ("serve_tiers", ds,
         lambda: serve_tiers_run(torch, np, dev, host_bw, keep.pop(ds),
                                 runs["main_run"]),
         "serve_tiers"),
        # DeepSeek-V2-Lite's backbone left with serve_tiers: its pinned
        # experts are freed before 236B's are pinned
        ("main_run_236b", ARCH_236B,
         lambda: main_run_236b(torch, np, dev, host_bw), ARCH_236B),
        ("parity_236b", ARCH_236B, lambda: parity_run_236b(torch, np, dev),
         None),
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
        ("examples_cli", ds, lambda: examples_cli_run(torch, np, dev),
         "examples_cli"),
        ("checkpoint", ds, lambda: checkpoint_run(torch, np, dev),
         "checkpoint"),
        ("dispatch", ds, lambda: dispatch_run(torch, np, dev), "dispatch"),
        ("mesh_train", ds, lambda: mesh_train_run(torch, np, dev),
         "mesh_train"),
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
        ("facade_scout", LLAMA4, lambda: facade_scout_run(torch, np, dev),
         "facade_scout"),
        ("facade_gemma3", "gemma3-27b",
         lambda: facade_gemma3_run(torch, np, dev), "facade_gemma3"),
        ("parity_gqa", LLAMA4, lambda: parity_run_gqa(torch, np, dev), None),
        ("facade_recurrentgemma", "recurrentgemma-9b",
         lambda: facade_recurrentgemma_run(torch, np, dev),
         "facade_recurrentgemma"),
        ("facade_seamless", "seamless-m4t-large-v2",
         lambda: facade_seamless_run(torch, np, dev), "facade_seamless"),
        ("parity_recurrent", "recurrentgemma-9b",
         lambda: parity_run_recurrent(torch, np, dev), None),
        ("main_run_3", MAMBA2, lambda: mamba_run(torch, np, dev), MAMBA2),
        ("parity_run_3", MAMBA2, lambda: parity_run_mamba(torch, np, dev),
         None))
    frozen = []
    for phase, arch, run_phase, key in phases:
        t = time.perf_counter()
        try:
            # nothing may compile, capture or load the library mid-run
            with guard.frozen(phase):
                if key is None:
                    runs[phase] = run_phase()
                else:
                    runs[phase], launches[key] = run_phase()
        except RetraceError as e:
            fail(str(e))
        frozen.append(phase)
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
        if "ship" in c:         # serve_tiers' ship rows past the slots
            sh = c["ship"]
            entry["ship_shape"] = {
                "max_abs_err": sh["bfloat16"],
                "max_abs_err_f32": sh["float32"], **timing_fields(sh)}
        if "dispatch" in c:     # the dispatch phase's per-shard call
            dp = c["dispatch"]
            entry["dispatch_shape"] = {
                "max_abs_err": dp["bfloat16"],
                "max_abs_err_f32": dp["float32"], **timing_fields(dp)}
        if "train" in c:        # the training forward's router
            entry["training_shapes"] = {
                shape: {"max_abs_err": c[shape]["float32"],
                        **timing_fields(c[shape])}
                for shape in ("train", "train_100m")}
        if "prefix_prefill" in c:   # a chunk after a sub-block match
            pre = c["prefix_prefill"]
            entry["prefix_prefill_shape"] = {
                "max_abs_err": pre["bfloat16"],
                "max_abs_err_f32": pre["float32"], **timing_fields(pre)}
        serve = {shape: {"max_abs_err": case["float32"],
                         **timing_fields(case)}
                 for shape, case in c.items() if shape.startswith("serve_")}
        if serve:               # serve_trained's engines on the 53.5 M backbone
            entry["serve_trained_shapes"] = serve
        v236 = {shape: {"max_abs_err": case.get("bfloat16", case["float32"]),
                        "max_abs_err_f32": case["float32"],
                        **timing_fields(case)}
                for shape, case in c.items() if shape.startswith("v236_")}
        if v236:                # main_run_236b's decode and prefill chunk
            entry["deepseek_v2_236b_shapes"] = v236
        for shape in ("gemma3_ring", "phi3_hd96", "gqa_prefill",
                      "recurrentgemma_ring", "seamless_cross"):
            if shape in c:      # the dense facades' decode shapes
                entry[f"{shape}_shape"] = {
                    "max_abs_err": c[shape]["bfloat16"],
                    "max_abs_err_f32": c[shape]["float32"],
                    **timing_fields(c[shape])}
        for shape in ("long", "reduced"):   # ssd_chunk's other shapes
            if shape in c:
                entry[f"{shape}_shape_max_abs_err"] = c[shape]
        kernels.append(entry)
    report = {"gpu": ident, "build_s": build_s, "phase_s": phase_s,
              "retrace_guard": {**retrace, "frozen_phases": frozen,
                                "counts": guard.counts()},
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
    big = runs["main_run_236b"]
    print(json.dumps({"main_run_236b": {k: big[k] for k in (
        "layers", "full_depth", "capacity_slots", "routed_experts",
        "pinned", "host_bw_bytes_per_s", "launches", "stream_digest",
        "route_digest", "hits", "misses", "max_memory_allocated_bytes",
        "clocks", "same_across_clocks")},
        "seconds": phase_s["main_run_236b"]}), flush=True)
    p236 = runs["parity_236b"]
    print(json.dumps({"parity_236b": {k: p236[k] for k in (
        "identical", "q_lora_rank", "streams", "stats", "card_launches")},
        "seconds": phase_s["parity_236b"]}), flush=True)
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
    ck = runs["checkpoint"]
    print(json.dumps({"checkpoint": {k: ck[k] for k in (
        "layers", "params", "leaves", "file_bytes", "save_s", "load_s",
        "save_bytes_per_s", "load_bytes_per_s", "train_s_with_save",
        "peak_rss_bytes", "rss_before_bytes", "bit_identical",
        "held_out_loss", "train_launches", "forward_launches")},
        "phase_s": phase_s["checkpoint"]}), flush=True)
    dp = runs["dispatch"]
    print(json.dumps({"dispatch": {k: dp[k] for k in (
        "ranks", "backend", "capacities", "spawn_to_done_s", "rank_wall_s",
        "rank_ready_s", "call_s", "max_abs_err", "launches_per_rank")},
        "phase_s": phase_s["dispatch"]}), flush=True)
    mt = runs["mesh_train"]
    print(json.dumps({"mesh_train": {k: mt[k] for k in (
        "ranks", "mesh", "batch", "seq", "steps", "data_parallel",
        "single_losses", "rank_losses", "max_loss_diff",
        "small_max_loss_diff", "small_max_param_diff", "spawn_to_done_s",
        "rank_ready_s", "s_per_step", "exchanged_bytes_per_step",
        "bytes_per_step", "bytes_want", "routed_digests_per_rank",
        "remat", "act_spec", "first_line", "small_remat_max_loss_diff",
        "small_remat_max_param_diff", "small_remat_bytes_per_step",
        "gathered_peak_bytes_per_step", "largest_unit_bytes",
        "largest_unit_want", "gathered_alive_after_bytes",
        "rank_param_bytes", "rank_moment_bytes", "sum_param_bytes",
        "replicated_param_bytes", "max_memory_allocated_bytes",
        "whole_tree_mesh_peak_bytes", "per_layer_mesh_peak_bytes",
        "model_parallel_mesh_peak_bytes", "vocab_parallel_mesh_peak_bytes",
        "rank_peak_rss_bytes", "rank_start_s", "rank_small_s",
        "launches_per_rank", "single_device_s")},
        **{arch: {k: mt[arch][k] for k in (
            "layers", "single_losses", "rank_losses", "max_loss_diff",
            "small_max_loss_diff", "small_max_param_diff", "s_per_step",
            "exchanged_bytes_per_step", "bytes_per_step", "remat",
            "bytes_want", "gathered_peak_bytes_per_step",
            "largest_unit_bytes", "largest_unit_want", "unit_shapes_want",
            "gathered_alive_after_bytes", "rank_param_bytes",
            "max_memory_allocated_bytes", "single_max_memory_allocated_bytes",
            "rank_small_s", "rank_train_s", "launches_per_rank")}
           for arch in MESH_TRAIN["archs"][1:]},
        "phase_s": phase_s["mesh_train"]}), flush=True)
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
    stl = runs["serve_telemetry"]
    print(json.dumps({"serve_telemetry": {k: stl[k] for k in (
        "run_s", "main_run_s", "overhead", "events", "trace_bytes",
        "export_s", "step_wall_s", "prefill_wall_s", "scoreboard_total",
        "stall_instants_by_critical_tier", "same_as_main_run")},
        "seconds": phase_s["serve_telemetry"]}), flush=True)
    pw = runs["parity_workload"]
    print(json.dumps({"parity_workload": {k: pw[k] for k in (
        "identical", "requests", "streams", "stats", "pool", "prefix")},
        "seconds": phase_s["parity_workload"]}), flush=True)
    sw = runs["serve_workload"]
    print(json.dumps({"serve_workload": {k: sw[k] for k in (
        "layers", "requests", "capacity_slots", "host_bw_bytes_per_s",
        "closed_loop_s", "run_s", "arrival_s", "positions_per_s",
        "generated_tokens_per_s", "closed_loop_positions_per_s",
        "latency_by_priority", "urgent_ttft_slo_s", "preemptions",
        "resumed_positions", "prefix", "prefix_hit_rate", "hit_rate",
        "closed_loop_hit_rate", "fetch_bytes", "closed_loop_fetch_bytes",
        "prefill_tokens", "closed_loop_prefill_tokens", "cow_copies",
        "retains", "preempt_ref_drops", "streams_equal_closed_loop",
        "first_divergence", "launches", "full_depth", "leak_checks")},
        "seconds": phase_s["serve_workload"]}), flush=True)
    pt = runs["parity_tiers"]
    print(json.dumps({"parity_tiers": {k: pt[k] for k in (
        "identical", "requests", "streams", "stats", "store", "dispatch",
        "cold_copies_compared", "launches")},
        "seconds": phase_s["parity_tiers"]}), flush=True)
    stt = runs["serve_tiers"]
    print(json.dumps({"serve_tiers": {
        **{k: stt[k] for k in ("layers", "capacity_slots",
                               "host_bw_bytes_per_s", "roofline",
                               "shard_dram_experts", "cache_experts",
                               "layer_compute_s", "main_run_digests",
                               "launches")},
        "runs": {label: {k: r[k] for k in (
            "tiers", "build_s", "run_s", "positions_per_s", "hit_rate",
            "sim_stall_s", "stall_by_tier", "overlapped_by_tier",
            "fetches_by_tier", "fetch_bytes_by_tier", "dispatch",
            "deep_prefetch_hits", "horizon_clamps", "evictions_learned",
            "evictions_lru", "spill_bytes", "spill_read_bytes_per_s",
            "stream_digest", "route_digest", *(
                ("streams_equal_c",) if label == "d" else ()),
            *(("leak_checks",) if label == "c" else ()))}
            for label, r in stt["runs"].items()}},
        "seconds": phase_s["serve_tiers"]}), flush=True)
    for phase in ("facade_scout", "facade_gemma3", "facade_recurrentgemma",
                  "facade_seamless"):
        fr = runs[phase]
        print(json.dumps({phase: {k: fr[k] for k in (
            "layers", "full_depth", "batch", "n_prefix", "prompt",
            "cache_len", "steps", "params", "param_bytes_on_device",
            "init_s", "prefill_s", "decode_ms_per_step",
            "decode_tokens_per_s", "launches", "vs_forward",
            "max_memory_allocated_bytes",
            *(k for k in ("trace_steps", "trace_s", "trace_steps_per_s",
                          "trace_launches", "encoder_s") if k in fr))},
            "seconds": phase_s[phase]}), flush=True)
    pg = runs["parity_gqa"]
    print(json.dumps({"parity_gqa": {k: pg[k] for k in (
        "identical", "max_abs_logit_err", "tolerance", "trace",
        "card_launches")}, "seconds": phase_s["parity_gqa"]}), flush=True)
    print(json.dumps({"parity_recurrent": runs["parity_recurrent"],
                      "seconds": phase_s["parity_recurrent"]}), flush=True)
    ex = runs["examples_cli"]
    print(json.dumps({"examples_cli": {k: ex[k] for k in (
        "seconds", "printed", "traces", "trace_experts_shape",
        "predictor_bit_identical", "predictor_same_logits",
        "backbone_file_bytes", "backbone_bit_identical", "launches")},
        "phase_s": phase_s["examples_cli"]}), flush=True)
    retrace.update(frozen_phases=len(frozen), new_in_frozen_phases=0,
                   counts_by_source=guard.by_source(),
                   library=guard.signatures(next(
                       p for p in guard.counts()
                       if p.startswith("kernel_library"))))
    print(json.dumps({"retrace_guard": retrace}), flush=True)
    print(json.dumps({"launch_floor_ms": floor_ms}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ident, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
