"""The port's expert-parallel dispatch (``launch.mesh.make_expert_group``,
``launch.sharding.expert_dispatch_ffn``) against the JAX reference on the
CPU.

Groups of 2 and 4 ranks are spawned processes joined by ``gloo`` over
``file://`` rendezvous in a temporary directory (no port is opened); each
rank gets its own experts and its own row of the reference test's send
buffers (``tests/test_dispatch.py``'s ``_dispatch_case``: ragged live
counts, ``-1`` padding). Every live token's output must match the
reference's ``expert_group_ffn`` on its expert within 1e-5, and the
4-rank result the reference's own ``expert_dispatch_ffn`` (run in a
subprocess with 4 forced host devices, which this process cannot set)
within 1e-5; padding is exactly 0. Every spawn is joined with a timeout
and its ranks stopped after it. This module imports no JAX at its top:
the ranks import it."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_expert_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
JOIN_TIMEOUT_S = 120.0


def _rank(rank, world, rendezvous, out_dir, case):
    """One rank: its experts and send row through ``expert_dispatch_ffn``
    in float32 and bfloat16, then the group's refusals."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        wg, wu, wd, x, eid = case
        group = make_expert_group(world)
        e_local = wg.shape[0] // world
        mine = [torch.from_numpy(w[rank * e_local:(rank + 1) * e_local])
                for w in (wg, wu, wd)]
        xs, es = torch.from_numpy(x[rank]), torch.from_numpy(eid[rank])
        out = sharding.expert_dispatch_ffn(group, *mine, xs, es)
        bf = sharding.expert_dispatch_ffn(
            group, *(w.bfloat16() for w in mine), xs.bfloat16(), es)
        flags = {"group_rank": dist.get_rank(group),
                 "group_size": dist.get_world_size(group),
                 "bf16_dtype": str(bf.dtype)}
        try:
            make_expert_group(world + 1)
            flags["refused_more_shards"] = False
        except ValueError:
            flags["refused_more_shards"] = True
        one = make_expert_group(1)
        flags["one_shard_rank"] = dist.get_rank(one)
        if flags["one_shard_rank"] < 0:
            try:
                sharding.expert_dispatch_ffn(one, *mine, xs[:1], es[:1])
                flags["outside_refused"] = False
            except ValueError:
                flags["outside_refused"] = True
        np.save(os.path.join(out_dir, f"out{rank}.npy"), out.numpy())
        np.save(os.path.join(out_dir, f"bf{rank}.npy"), bf.float().numpy())
        with open(os.path.join(out_dir, f"flags{rank}.json"), "w") as f:
            json.dump(flags, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, out_dir, case):
    """Run ``_rank`` on ``world`` spawned processes; fail on a rank that
    raises, dies or outlasts ``JOIN_TIMEOUT_S``."""
    ctx = mp.start_processes(
        _rank, args=(world, os.path.join(out_dir, "rendezvous"), out_dir,
                     case),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{world} dispatch ranks did not finish within "
                            f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    return (np.stack([np.load(os.path.join(out_dir, f"out{r}.npy"))
                      for r in range(world)]),
            np.stack([np.load(os.path.join(out_dir, f"bf{r}.npy"))
                      for r in range(world)]),
            [json.load(open(os.path.join(out_dir, f"flags{r}.json")))
             for r in range(world)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{S: (case, float32 out, bfloat16 out, flags)} for S 2 and 4."""
    from test_dispatch import _dispatch_case
    out = {}
    for world in (2, 4):
        case = _dispatch_case(world)
        out[world] = (case, *_spawn(
            world, str(tmp_path_factory.mktemp(f"dispatch{world}")), case))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_dispatch_matches_expert_group_ffn(runs, world):
    """Each live token's output is the reference's ``expert_group_ffn`` on
    its expert (1e-5, float32), back at its place on its source rank;
    padding exactly 0 in float32 and bfloat16, whose run keeps its dtype
    and stays within bfloat16 rounding of the float32 one."""
    from repro.models.moe import expert_group_ffn
    (wg, wu, wd, x, eid), out, bf, flags = runs[world]
    assert out.shape == x.shape
    assert [f["group_rank"] for f in flags] == list(range(world))
    assert all(f["group_size"] == world for f in flags)
    assert all(f["bf16_dtype"] == "torch.bfloat16" for f in flags)
    live = eid >= 0
    assert live.any() and (~live).any()
    np.testing.assert_array_equal(out[~live], 0.0)
    np.testing.assert_array_equal(bf[~live], 0.0)
    for s, dest, c in zip(*np.nonzero(live)):
        e_id = int(eid[s, dest, c])
        ref = np.asarray(expert_group_ffn(wg[e_id], wu[e_id], wd[e_id],
                                          x[s, dest, c][None]))[0]
        np.testing.assert_allclose(out[s, dest, c], ref, **TOL)
    np.testing.assert_allclose(bf, out, rtol=5e-2,
                               atol=5e-2 * np.abs(out).max())


def test_dispatch_matches_reference_mesh_program(runs, tmp_path):
    """4 ranks against the reference's ``expert_dispatch_ffn`` on a
    4-device ``("expert",)`` mesh of forced host devices, in a
    subprocess: within 1e-5, padding exactly 0 in both."""
    case, out, _, _ = runs[4]
    inp = os.path.join(tmp_path, "case.npz")
    np.savez(inp, **dict(zip(("wg", "wu", "wd", "x", "eid"), case)))
    res = os.path.join(tmp_path, "ref.npy")
    code = (
        "import numpy as np\n"
        "from repro.launch.mesh import make_expert_mesh\n"
        "from repro.launch.sharding import expert_dispatch_ffn\n"
        f"c = np.load({inp!r})\n"
        "out = expert_dispatch_ffn(make_expert_mesh(4), c['wg'], c['wu'], "
        "c['wd'], c['x'], c['eid'])\n"
        f"np.save({res!r}, np.asarray(out))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    ref = np.load(res)
    pad = case[4] < 0
    np.testing.assert_array_equal(ref[pad], 0.0)
    np.testing.assert_array_equal(out[pad], 0.0)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_make_expert_group_refuses_more_shards_than_ranks(runs, world):
    """More shards than ranks raise on every rank; a 1-shard group holds
    rank 0 alone, and a rank outside it cannot dispatch."""
    flags = runs[world][3]
    assert all(f["refused_more_shards"] for f in flags)
    assert [f["one_shard_rank"] for f in flags] == [0] + [-1] * (world - 1)
    assert all(f["outside_refused"] for f in flags[1:])


def test_shard_ffn_cut_into_max_pairs_runs_equals_one_run(monkeypatch):
    """The per-shard compute in runs of ``MAX_PAIRS`` (patched to 5: 24
    received tokens make 5 ``expert_ffn`` calls) equals one uncut call
    within 1e-6 (the plain version's batched products round by batch
    size, an ulp apart); padding rows are exact zeros, live rows are
    not."""
    rng = np.random.default_rng(4)
    s, c, e_local, d, f, shard = 4, 6, 3, 8, 12, 1
    w = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
         for shape in ((e_local, d, f), (e_local, d, f), (e_local, f, d))]
    x = torch.from_numpy(rng.normal(size=(s, c, d)).astype(np.float32))
    eid = torch.from_numpy(rng.integers(
        shard * e_local, (shard + 1) * e_local, (s, c)).astype(np.int32))
    eid[:, -2:] = -1
    calls = []
    inner = sharding.expert_ffn
    monkeypatch.setattr(sharding, "expert_ffn",
                        lambda *a: calls.append(a[0].shape[0]) or inner(*a))
    whole = sharding.shard_ffn(*w, x, eid, shard)
    assert calls == [s * c]
    monkeypatch.setattr(sharding, "MAX_PAIRS", 5)
    cut = sharding.shard_ffn(*w, x, eid, shard)
    assert calls[1:] == [5, 5, 5, 5, 4]
    torch.testing.assert_close(cut, whole, rtol=1e-6, atol=1e-6)
    assert (whole[:, -2:] == 0).all() and (whole[:, :-2] != 0).any()
