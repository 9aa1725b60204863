"""The port's kernel modules on the CPU: each plain PyTorch version (what
the wrapper runs for a CPU tensor) against the JAX Pallas kernel run in
interpret mode, on the same numpy inputs.

Tolerances: float32 ``atol=rtol=1e-5`` — the same algorithm in f32, only
the summation order differs; bfloat16 ``2e-2`` — outputs are rounded to
bf16 (8 significant bits, ~4e-3 relative) after f32 accumulation, and the
two frameworks round intermediates at different places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.expert_ffn import expert_ffn as expert_ffn_pallas
from repro.kernels.paged_attention import paged_flash_decode_pallas
from repro.kernels.topk_gating import topk_gating as topk_gating_pallas
from repro_torch.kernels import (expert_ffn, launch_counts, paged_attention,
                                 reset_launch_counts, topk_gating)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype):
    """numpy -> torch in the working dtype (bf16 via f32, like jnp)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _paged_case(bs, kvh, g, hd, w, n, seed, pad_w=2):
    rng = np.random.default_rng(seed)
    nb = n * w + 3                       # spare blocks stay unreferenced
    q = rng.normal(size=(n, kvh, g, hd)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    perm = rng.permutation(nb - 1)[: n * w] + 1          # never scratch
    tables = np.zeros((n, w + pad_w), np.int32)          # scratch-padded
    tables[:, :w] = perm.reshape(n, w)
    pos = rng.integers(0, w * bs, size=n).astype(np.int32)
    pos[0] = (w - 1) * bs + bs // 2 - 1                  # ends mid-block
    pos[-1] = w * bs - 1
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("kvh,g", [(1, 4), (2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_plain_matches_pallas(bs, kvh, g, dtype):
    q, kp, vp, tables, pos = _paged_case(bs, kvh, g, hd=32, w=3, n=3,
                                         seed=bs * 10 + kvh)
    ref = paged_flash_decode_pallas(
        jnp.asarray(q, JDT[dtype]), jnp.asarray(kp, JDT[dtype]),
        jnp.asarray(vp, JDT[dtype]), jnp.asarray(tables), jnp.asarray(pos),
        interpret=True)
    got = paged_attention.paged_flash_decode(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype),
        torch.from_numpy(tables), torch.from_numpy(pos))
    assert got.dtype == TDT[dtype] and got.shape == (3, kvh, g, 32)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_mla_layout(dtype):
    """Shared page (``v_pool=None``): V = the first ``dv`` features of the
    K page, with the MLA score-scale override."""
    q, kp, _, tables, pos = _paged_case(bs=8, kvh=1, g=4, hd=48, w=4, n=2,
                                        seed=7)
    scale, dv = 0.125, 32
    ref = paged_flash_decode_pallas(
        jnp.asarray(q, JDT[dtype]), jnp.asarray(kp, JDT[dtype]), None,
        jnp.asarray(tables), jnp.asarray(pos), scale=scale, dv=dv,
        interpret=True)
    got = paged_attention.paged_flash_decode(
        _t(q, dtype), _t(kp, dtype), None, torch.from_numpy(tables),
        torch.from_numpy(pos), scale=scale, dv=dv)
    assert got.shape == (2, 1, 4, dv)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_paged_flash_decode_scratch_invariance():
    """The scratch block and blocks no table references below ``pos``
    contribute exactly zero: overwriting them changes nothing, and no
    NaN appears from scratch-padded table tails."""
    rng = np.random.default_rng(0)
    bs, kvh, g, hd, nb = 8, 2, 2, 16, 8
    q = torch.from_numpy(rng.normal(size=(2, kvh, g, hd)).astype(np.float32))
    kp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    tables = torch.tensor([[3, 5], [6, 0]], dtype=torch.int32)
    pos = torch.tensor([15, 4], dtype=torch.int32)
    kp2, vp2 = kp.copy(), vp.copy()
    for b in (0, 1, 2, 4, 7):
        kp2[b] = 99.0
        vp2[b] = -99.0
    out1 = paged_attention.paged_flash_decode(
        q, torch.from_numpy(kp), torch.from_numpy(vp), tables, pos)
    out2 = paged_attention.paged_flash_decode(
        q, torch.from_numpy(kp2), torch.from_numpy(vp2), tables, pos)
    assert torch.isfinite(out1).all()
    assert torch.equal(out1, out2)
    ref = paged_flash_decode_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(kp2), jnp.asarray(vp2),
        jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()),
        interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_plain_matches_pallas(dtype):
    """One lane through the slot-indexed plain version equals the TPU
    kernel over the same k experts."""
    rng = np.random.default_rng(1)
    k, d, f, s = 3, 128, 256, 5
    x = rng.normal(size=(d,)).astype(np.float32)
    w = (rng.random(k) + 0.1).astype(np.float32)
    wg = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(s, f, d)) * 0.05).astype(np.float32)
    slots = np.array([4, 0, 2], np.int32)
    ref = expert_ffn_pallas(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(w),
        jnp.asarray(wg[slots], JDT[dtype]), jnp.asarray(wu[slots], JDT[dtype]),
        jnp.asarray(wd[slots], JDT[dtype]), interpret=True)
    got = expert_ffn.expert_ffn(
        _t(x[None], dtype), torch.from_numpy(w[None]),
        torch.from_numpy(slots[None]), _t(wg, dtype), _t(wu, dtype),
        _t(wd, dtype))
    assert got.dtype == TDT[dtype] and got.shape == (1, d)
    np.testing.assert_allclose(_np(got)[0], _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_expert_ffn_batched_matches_engine_gather():
    """The batched slot-indexed form equals what the reference engine's
    ``expert_from_slots`` does: gather (N, k) slot weights, vmap the TPU
    kernel over lanes. Repeated slots within and across lanes."""
    rng = np.random.default_rng(2)
    n, k, d, f, s = 4, 2, 128, 128, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.random((n, k)).astype(np.float32)
    wg = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(s, f, d)) * 0.05).astype(np.float32)
    slot_idx = np.array([[1, 5], [5, 1], [0, 0], [3, 2]], np.int32)
    flat = slot_idx.reshape(-1)

    def gathered(buf):
        return jnp.take(jnp.asarray(buf), flat, 0).reshape(
            (n, k) + buf.shape[1:])

    ref = jax.vmap(lambda xr, wr, g_, u_, d_: expert_ffn_pallas(
        xr, wr, g_, u_, d_, interpret=True))(
        jnp.asarray(x), jnp.asarray(w), gathered(wg), gathered(wu),
        gathered(wd))
    got = expert_ffn.expert_ffn(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(slot_idx),
        torch.from_numpy(wg), torch.from_numpy(wu), torch.from_numpy(wd))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("t,e,k", [(7, 16, 2), (8, 64, 6), (33, 160, 6),
                                   (4, 8, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_gating_plain_matches_pallas_and_top_k(t, e, k, dtype):
    """Ids equal the TPU kernel's and ``lax.top_k``'s exactly (selection
    order included), with rows of exact ties: bf16 logits repeat values,
    and rows 0/1 are built from duplicates."""
    rng = np.random.default_rng(t * 100 + e)
    logits = (rng.normal(size=(t, e)) * 2).astype(np.float32)
    logits[0] = np.repeat(rng.normal(size=(e // 2,)), 2)[:e]
    logits[1] = 0.5                                      # all tied
    jl = jnp.asarray(logits, JDT[dtype])
    wp, ip = topk_gating_pallas(jl, k, interpret=True)
    probs = jax.nn.softmax(jl.astype(jnp.float32), axis=-1)
    wt, it = jax.lax.top_k(probs, k)
    got_w, got_i = topk_gating.topk_gating(_t(logits, dtype), k)
    assert got_i.dtype == torch.int32 and got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ip))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(it))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(wp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_w.numpy().sum(-1), 1.0, atol=1e-5)


def test_cpu_path_counts_no_launch():
    """Launch counters move only where a kernel launches: the plain CPU
    path leaves them at zero."""
    reset_launch_counts()
    topk_gating.topk_gating(torch.zeros((2, 8)), 2)
    assert launch_counts() == {"paged_flash_decode": 0, "expert_ffn": 0,
                               "topk_gating": 0}
