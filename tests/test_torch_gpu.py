"""Kernel-vs-plain and GPU-vs-CPU pins of the port that need the card.

Marked ``gpu``: each test skips without a CUDA device. On a machine with
one (and without JAX), run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
This file imports nothing of JAX.
"""
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.policies import NextLayerAllPolicy
from repro_torch.kernels import (expert_ffn, flash_attention, launch_counts,
                                 paged_attention, reset_launch_counts,
                                 topk_gating)
from repro_torch.models.model import build_model
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.scheduler import BatchedOffloadEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_kernels_match_plain_on_card(cuda, dtype, tol):
    """Each kernel against its plain version on the same card tensors
    (f32: summation order only; bf16: output rounding)."""
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(3, 1, 4, 48, generator=g, device=cuda).to(dtype)
    pool = torch.randn(10, 8, 1, 48, generator=g, device=cuda).to(dtype)
    tab = torch.tensor([[1, 2, 0], [3, 4, 5], [6, 0, 0]], dtype=torch.int32,
                       device=cuda)
    pos = torch.tensor([12, 23, 0], dtype=torch.int32, device=cuda)
    o = paged_attention.paged_flash_decode(q, pool, None, tab, pos,
                                           scale=0.2, dv=32)
    op = paged_attention.paged_flash_decode_plain(q, pool, None, tab, pos,
                                                  scale=0.2, dv=32)
    assert (o.float() - op.float()).abs().max().item() <= tol

    x = torch.randn(4, 128, generator=g, device=cuda).to(dtype)
    wg = (torch.randn(5, 128, 64, generator=g, device=cuda) * .1).to(dtype)
    wu = (torch.randn(5, 128, 64, generator=g, device=cuda) * .1).to(dtype)
    wd = (torch.randn(5, 64, 128, generator=g, device=cuda) * .1).to(dtype)
    w = torch.rand(4, 2, generator=g, device=cuda)
    sl = torch.tensor([[0, 4], [4, 0], [2, 2], [1, 3]], dtype=torch.int32,
                      device=cuda)
    y = expert_ffn.expert_ffn(x, w, sl, wg, wu, wd)
    yp = expert_ffn.expert_ffn_plain(x, w, sl, wg, wu, wd)
    assert (y.float() - yp.float()).abs().max().item() <= tol

    lg = torch.randn(6, 16, generator=g, device=cuda)
    lg[0] = 1.0                                        # exact ties
    wk, ik = topk_gating.topk_gating(lg, 4)
    wp, ip = topk_gating.topk_gating_plain(lg, 4)
    assert torch.equal(ik, ip)
    assert (wk - wp).abs().max().item() <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gqa_attention_kernels_match_plain_on_card(cuda, dtype, tol):
    """``flash_decode`` (rows indexed in the kernel, S not a multiple of its
    tile, valid_len 1/mid/S) and ``paged_flash_decode``'s GQA layout
    (separate K and V pools) against their plain versions."""
    g = torch.Generator(cuda).manual_seed(1)
    q = torch.randn(3, 8, 64, generator=g, device=cuda).to(dtype)
    kc = torch.randn(4, 70, 2, 64, generator=g, device=cuda).to(dtype)
    vc = torch.randn(4, 70, 2, 64, generator=g, device=cuda).to(dtype)
    rows = torch.tensor([3, 0, 2], dtype=torch.int32, device=cuda)
    vlen = torch.tensor([1, 33, 70], dtype=torch.int32, device=cuda)
    o = flash_attention.flash_decode(q, kc, vc, rows, vlen)
    op = flash_attention.flash_decode_plain(q, kc, vc, rows, vlen)
    assert (o.float() - op.float()).abs().max().item() <= tol

    qg = q.reshape(3, 2, 4, 64).contiguous()
    kp = torch.randn(10, 8, 2, 64, generator=g, device=cuda).to(dtype)
    vp = torch.randn(10, 8, 2, 64, generator=g, device=cuda).to(dtype)
    tab = torch.tensor([[1, 2, 0], [3, 4, 5], [6, 0, 0]], dtype=torch.int32,
                       device=cuda)
    pos = torch.tensor([12, 23, 0], dtype=torch.int32, device=cuda)
    o = paged_attention.paged_flash_decode(qg, kp, vp, tab, pos)
    op = paged_attention.paged_flash_decode_plain(qg, kp, vp, tab, pos)
    assert (o.float() - op.float()).abs().max().item() <= tol


@pytest.mark.parametrize("arch,paged", [("deepseek-v2-lite", True),
                                        ("llama4-scout-17b-a16e", True),
                                        ("llama4-scout-17b-a16e", False)])
def test_engine_on_card_matches_cpu(cuda, arch, paged):
    """The reduced engine on the card (kernels) and on the CPU (plain
    versions) from identical weights: identical streams and counters, and
    every kernel of the path launched on the card."""
    cfg = get_reduced(arch)
    model = build_model(cfg)
    params = model.init(device="cpu")
    prompts = [[3, 17, 5], [99, 255, 7, 42, 11, 4, 9, 250, 33, 2]]
    outs, stats = [], []
    for dev in ("cpu", "cuda"):
        reset_launch_counts()
        serve = ServeConfig(max_batch=2, block_size=4, paged=paged)
        eng = BatchedOffloadEngine(model, params,
                                   NextLayerAllPolicy(cfg.moe.num_experts),
                                   8, serve=serve, device=dev)
        outs.append(eng.generate(prompts, 4, 24))
        stats.append((eng.stats.hits, eng.stats.misses,
                      eng.stats.fetch_bytes, eng.stats.sim_stall_s))
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    want = {"deepseek-v2-lite": ("paged_flash_decode", "expert_ffn",
                                 "topk_gating")}.get(
        arch, ("flash_decode", "expert_ffn", "topk_gating")
        + (("paged_flash_decode",) if paged else ()))
    counts = launch_counts()
    assert all(counts[k] > 0 for k in want), counts
