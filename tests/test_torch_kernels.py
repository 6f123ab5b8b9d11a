"""The port's CUDA kernels against their plain PyTorch versions.

This file imports only torch, numpy and the port, so it runs on the
machine with the card, which has no JAX reference stack:

    python -m pytest -m gpu tests/test_torch_kernels.py

The ``gpu`` tests skip here (no card); the others check, on the CPU, that
the wrappers run their plain versions for CPU tensors and count no
launch."""

import numpy as np
import pytest
import torch

from partisan_tpu_torch.config import Config
from partisan_tpu_torch.models import demers, hyparview_dense
from partisan_tpu_torch.ops import (bitset, route_kernel, rumor_kernel,
                                    rumor_kernel_hbm, shard_exchange)
from partisan_tpu_torch.parallel import dense_dataplane, mesh

CELL = 4096


def packed_world(n, seed, hot_frac=0.5, dead_frac=0.1, device="cpu"):
    rng = np.random.default_rng(seed)
    inf = rng.random(n) < 0.2
    masks = (inf, inf & (rng.random(n) < hot_frac),
             rng.random(n) >= dead_frac)
    words = [bitset.from_mask(torch.from_numpy(m)).to(device) for m in masks]
    return demers.RumorWorldPacked(
        *words, torch.tensor(seed, dtype=torch.int32, device=device))


def route_targets(m, n, seed, device="cpu"):
    """80% of the rows in [0, n), the rest -1 or just outside."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-2, n + 2, m)
    t = np.where(rng.random(m) < 0.8, t, -1).astype(np.int32)
    return torch.from_numpy(t).to(device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run: pytest -m gpu)")
    return torch.device("cuda")


def test_cpu_tensors_run_the_plain_versions_without_launching():
    n = 2 * CELL
    w = packed_world(n, 1)
    before = (rumor_kernel.LAUNCHES, rumor_kernel_hbm.LAUNCHES)
    a = rumor_kernel.rumor_run_fused(w, 5, n, 2, 3, 0.01)
    b = rumor_kernel_hbm.rumor_run_hbm(w, 5, n, 2, 3, 0.01, 1, True)
    assert (rumor_kernel.LAUNCHES, rumor_kernel_hbm.LAUNCHES) == before
    for out in (a, b):
        assert out.infected.device.type == "cpu"
        assert int(out.rnd) == int(w.rnd) + 5
        assert torch.equal(out.alive, w.alive)


def test_cpu_reverse_select_runs_the_plain_version_without_launching():
    t = route_targets(300, 40, 1)
    before = route_kernel.LAUNCHES
    got = shard_exchange.reverse_select(t, 5, 40, 2)
    assert route_kernel.LAUNCHES == before
    assert torch.equal(got, route_kernel.reverse_select_plain(t, 5, 40, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        route_kernel.reverse_select_cuda(t, 5, 40, 2)
    assert route_kernel.LAUNCHES == before


def test_hbm_plain_churn_reaches_the_endemic_window():
    """The counter-based churn generator keeps the epidemic's equilibrium:
    at 1% churn a run settles where the reference's does."""
    n = 4 * CELL
    w = demers.rumor_pack(demers.rumor_init(n, 3, device="cpu"))
    out = rumor_kernel_hbm.rumor_run_hbm(w, 400, n, 2, 1, 0.01, 1, True)
    assert 0.55 < bitset.count(out.infected) / n < 0.75


DYING = 0.6   # churn at fanout 1 that kills the rumor every few rounds


def fused_worlds(world, n, rounds, fanout, device):
    """(world, table) pairs for K3.  "random": ~20% infected, half of them
    hot or none hot (the first round restarts).  "dying": churn 0.6 at
    fanout 1 kills the rumor every few rounds.  "ends": the same world with
    patient zero in word 0 on even rounds and in the last word on odd ones,
    and the call cut after its last restart, so the final round restarts."""
    if world == "random":
        for seed, hot_frac in ((1, 0.5), (2, 0.0)):
            w = packed_world(n, seed, hot_frac, device=device)
            yield w, rumor_kernel.rumor_table(int(w.rnd), rounds, n, fanout)
        return
    w = packed_world(n, 3, 0.5, device=device)
    table = rumor_kernel.rumor_table(int(w.rnd), rounds, n, fanout)
    if world == "ends":
        table[0::2, -1] = torch.arange(0, rounds, 2) % 32
        table[1::2, -1] = n - 1 - torch.arange(1, rounds, 2) % 32
        died = []
        rumor_kernel.rumor_run_fused_plain(w, table, n, 1, DYING, died)
        assert {0, 1} <= {d % 2 for d in died}
        table = table[:died[-1] + 1]
    yield w, table


FUSED_CASES = [  # n, rounds, fanout, stop_k, churn, world
    *((n, r, f, k, c, "random")
      for n, r, f in ((CELL, 1, 2), (CELL, 2, 2), (CELL, 61, 1),
                      (CELL, 61, 2), (CELL, 61, 3), (4 * CELL, 60, 2),
                      (4 * CELL, 61, 5))
      for k in (1, 3) for c in (0.0, 0.01)),
    (CELL, 200, 1, 1, DYING, "dying"), (4 * CELL, 200, 1, 3, DYING, "dying"),
    (CELL, 200, 1, 1, DYING, "ends"), (4 * CELL, 200, 1, 1, DYING, "ends"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,rounds,fanout,stop_k,churn,world", FUSED_CASES)
def test_fused_kernel_matches_plain(cuda, n, rounds, fanout, stop_k, churn,
                                    world):
    for w, table in fused_worlds(world, n, rounds, fanout, cuda):
        want = rumor_kernel.rumor_run_fused_plain(w, table, n, stop_k, churn)
        before = rumor_kernel.LAUNCHES
        got = rumor_kernel.rumor_run_fused_cuda(w, table, n, stop_k, churn)
        torch.cuda.synchronize()
        assert rumor_kernel.LAUNCHES == before + 1
        assert torch.equal(want.infected, got.infected)
        assert torch.equal(want.hot, got.hot)


@pytest.mark.gpu
def test_fused_kernel_words_past_the_grid(cuda):
    """At N=2^24 the words (2^19) outnumber the threads the card holds at
    once, so the grid strides: the words past it take the round's tail
    loop and compute their masks in the round."""
    n = 1 << 24
    w = packed_world(n, 4, 0.5, device=cuda)
    table = rumor_kernel.rumor_table(int(w.rnd), 40, n, 2)
    want = rumor_kernel.rumor_run_fused_plain(w, table, n, 3, 0.3)
    got = rumor_kernel.rumor_run_fused_cuda(w, table, n, 3, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(want.infected, got.infected)
    assert torch.equal(want.hot, got.hot)


@pytest.mark.gpu
def test_fused_main_path_equals_packed(cuda):
    """The headline entry point at full width: "fused" (one K3 launch)
    equals the packed scan; without churn the rumor covers ~98% of the
    nodes (0.9796 in the packed dynamics from patient zero 5)."""
    n = 1 << 20
    w = demers.rumor_init(n, 5, device=cuda)
    before = rumor_kernel.LAUNCHES
    out = demers.rumor_run(w, 300, n, 2, 1, 0.0, "fused")
    assert rumor_kernel.LAUNCHES == before + 1
    want = demers.rumor_run(w, 300, n, 2, 1, 0.0, "packed")
    assert torch.equal(out.infected, want.infected)
    assert torch.equal(out.hot, want.hot)
    assert float(out.infected.float().mean()) > 0.95


@pytest.mark.gpu
@pytest.mark.parametrize("churn", [0.0, 0.01])
@pytest.mark.parametrize("stop_k", [1, 3])
@pytest.mark.parametrize("all_alive", [False, True])
def test_hbm_kernel_matches_plain(cuda, all_alive, stop_k, churn):
    n = 8 * CELL
    for seed, hot_frac in ((1, 0.5), (2, 0.0)):
        w = packed_world(n, seed, hot_frac, device=cuda)
        table = rumor_kernel_hbm.hbm_table(int(w.rnd), 6, n, 2)
        want = rumor_kernel_hbm.rumor_run_hbm_plain(w, table, n, stop_k,
                                                    churn, all_alive)
        before = rumor_kernel_hbm.LAUNCHES
        got = rumor_kernel_hbm.rumor_run_hbm_cuda(w, table, n, stop_k, churn,
                                                  all_alive)
        torch.cuda.synchronize()
        assert rumor_kernel_hbm.LAUNCHES == before + 1
        assert torch.equal(want.infected, got.infected)
        assert torch.equal(want.hot, got.hot)


HBM_CASES = [  # n, rounds, fanout, stop_k, churn, all_alive, hot_frac
    (8 * CELL, 1, 2, 3, 0.01, False, 0.5),
    (8 * CELL, 2, 2, 3, 0.01, False, 0.0),
    (8 * CELL, 2, 2, 1, 0.01, True, 0.0),
    (CELL, 61, 2, 3, 0.01, False, 0.5),
    (13 * CELL, 61, 1, 1, 0.01, False, 0.5),
    (13 * CELL, 61, 3, 3, 0.3, True, 0.5),
    (8 * CELL, 200, 1, 1, DYING, False, 0.5),
    (8 * CELL, 200, 1, 3, DYING, True, 0.5),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,rounds,fanout,stop_k,churn,all_alive,hot_frac",
                         HBM_CASES)
def test_hbm_kernel_cases(cuda, n, rounds, fanout, stop_k, churn, all_alive,
                          hot_frac):
    """1 and 2 rounds (a restart on round 1 from a world with no hot
    node), one row (fewer rows than a block's 8), 13 rows (a ragged
    grid), fanout 1 and 3, and a dying world (churn 0.6 at fanout 1) that
    restarts many times: one launch a call, bit-equal to the plain
    version."""
    w = packed_world(n, rounds + fanout, hot_frac, device=cuda)
    table = rumor_kernel_hbm.hbm_table(int(w.rnd), rounds, n, fanout)
    died = []
    want = rumor_kernel_hbm.rumor_run_hbm_plain(w, table, n, stop_k, churn,
                                                all_alive, died)
    before = rumor_kernel_hbm.LAUNCHES
    got = rumor_kernel_hbm.rumor_run_hbm_cuda(w, table, n, stop_k, churn,
                                              all_alive)
    torch.cuda.synchronize()
    assert rumor_kernel_hbm.LAUNCHES == before + 1
    assert torch.equal(want.infected, got.infected)
    assert torch.equal(want.hot, got.hot)
    if churn == DYING:
        assert len(died) >= rounds // 10, died
    if hot_frac == 0.0:
        assert died[0] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n,rounds", [(1 << 24, 40), (1 << 26, 6)])
def test_hbm_entry_at_the_big_n_sizes(cuda, n, rounds):
    """The entry point at 2^24 (two words a thread) and 2^26, where the
    words (2^21) outnumber the threads the card holds at once eight to
    one: one launch a call, bit-equal to the plain version."""
    w = packed_world(n, 4, 0.5, device=cuda)
    before = rumor_kernel_hbm.LAUNCHES
    got = rumor_kernel_hbm.rumor_run_hbm(w, rounds, n, 2, 1, 0.01, 1024,
                                         True)
    torch.cuda.synchronize()
    assert rumor_kernel_hbm.LAUNCHES == before + 1
    table = rumor_kernel_hbm.hbm_table(int(w.rnd), rounds, n, 2)
    want = rumor_kernel_hbm.rumor_run_hbm_plain(w, table, n, 1, 0.01, True)
    assert torch.equal(want.infected, got.infected)
    assert torch.equal(want.hot, got.hot)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,c", [(1 << 20, 1 << 20, 2), (1000003, 1 << 18, 4),
                                   (1 << 20, 7, 3), (1, 1, 1), (4097, 100, 1),
                                   (4096, 4096, 2), (5000, 300, 5)])
def test_route_kernel_matches_plain(cuda, m, n, c):
    t = route_targets(m, n, m + n + c, cuda)
    for salt in (0, 0x9E3779B9, 0xFFFFFFFF):
        want = route_kernel.reverse_select_plain(t, salt, n, c)
        before = route_kernel.LAUNCHES
        got = route_kernel.reverse_select_cuda(t, salt, n, c)
        torch.cuda.synchronize()
        assert route_kernel.LAUNCHES == before + 1
        assert torch.equal(want, got)
    none = torch.full((9,), -1, dtype=torch.int32, device=cuda)
    assert (route_kernel.reverse_select_cuda(none, 3, 4, 2) == -1).all()


@pytest.mark.gpu
def test_dense_round_on_the_card_equals_the_cpu(cuda):
    """The whole dense path (every torch op and K1) on the card against
    the same path on the CPU, which the parity tests hold to the
    reference: every leaf bit-equal after churned every-round and
    staggered rounds at N=4096."""
    cfg = Config(n_nodes=4096)
    out = {}
    for dev in ("cpu", cuda):
        before = route_kernel.LAUNCHES
        s = hyparview_dense.dense_init(cfg, device=dev)
        s = hyparview_dense.run_dense(s, 12, cfg, 0.01)
        s = hyparview_dense.run_dense_staggered(s, 1, cfg, 0.01, 5)
        out[str(dev)] = hyparview_dense.state_to_numpy(s)
        launched = route_kernel.LAUNCHES - before
        assert launched == (0 if dev == "cpu" else 12 * 2 + 3), launched
    for f in ("active", "passive", "alive", "rnd", "partition"):
        np.testing.assert_array_equal(getattr(out["cpu"], f),
                                      getattr(out["cuda"], f), err_msg=f)


def shard_ids(shape, d, seed, invalid=1 / 3, device="cpu"):
    """int32 shard ids in [0, d], about ``invalid`` of them d."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, d, shape)
    s = np.where(rng.random(shape) < invalid, d, s).astype(np.int32)
    return torch.from_numpy(s).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,d,b,invalid", [
    ((8, 2359296), 8, 589824, 1 / 3), ((8, 100003), 8, 2000, 0.2),
    ((1,), 1, 1, 0.0), ((3, 1), 8, 16, 0.5), ((2, 5000), 8, 16, 1.0),
    ((4097,), 1, 100, 0.3), ((4, 777), 255, 3, 0.1), ((2, 256), 2, 300, 0.0)])
def test_bucket_pack_kernel_matches_plain(cuda, shape, d, b, invalid):
    s = shard_ids(shape, d, sum(shape) + d, invalid, cuda)
    want = route_kernel.bucket_pack_plain(s, d, b)
    before = route_kernel.PACK_LAUNCHES
    got = route_kernel.bucket_pack_cuda(s, d, b)
    torch.cuda.synchronize()
    assert route_kernel.PACK_LAUNCHES == before + 1
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.gpu
@pytest.mark.parametrize("model,cfg_kw,kw", [
    ("hyparview", dict(shuffle_interval=4, random_promotion_interval=2),
     dict(churn=0.02)),
    ("plumtree", dict(shuffle_interval=4, random_promotion_interval=2),
     dict(model="plumtree")),
    ("scamp", {}, dict(model="scamp", churn=0.01))])
def test_sharded_round_on_the_card_equals_the_cpu(cuda, model, cfg_kw, kw):
    """The sharded round (K2, D K1 calls and every torch op) on the card
    against the same round on the CPU, which the parity tests hold to the
    reference: every leaf bit-equal after 12 rounds at N=4096, D=8."""
    cfg = Config(n_nodes=4096, **cfg_kw)
    init = {"hyparview": dense_dataplane.sharded_dense_init,
            "plumtree": dense_dataplane.sharded_pt_init,
            "scamp": dense_dataplane.sharded_scamp_init}[model]
    out = {}
    for dev in ("cpu", cuda):
        before = (route_kernel.LAUNCHES, route_kernel.PACK_LAUNCHES)
        step = dense_dataplane.make_sharded_dense_round(
            cfg, mesh.make_mesh(8, dev), **kw)
        st = dense_dataplane.run_sharded(step, init(cfg, 8, device=dev), 12)
        out[str(dev)] = dense_dataplane.state_to_numpy(st)
        launched = (route_kernel.LAUNCHES - before[0],
                    route_kernel.PACK_LAUNCHES - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (12 * 8, 12))
    flat = [(f, getattr(out["cpu"], f), getattr(out["cuda"], f))
            for f in type(out["cpu"])._fields]
    for f, a, b in flat:
        if f == "hv":
            flat += [(f"hv.{g}", getattr(a, g), getattr(b, g))
                     for g in type(a)._fields]
            continue
        np.testing.assert_array_equal(a, b, err_msg=f)
