#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``partisan_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``partisan_tpu_torch/csrc/`` (nvcc, into
``build/``), then:

0. prints the card's name and power limit and the build time;
1. K3 (rumor_fused.cu) against its plain version, bit-equality of
   infected and hot: at N=2^20, fanout 2, churn 0.01, 64 rounds from
   rumor_init(n, 5) with stop_k 1 and on a random world with stop_k 3;
   N=4096; 1 and 2 rounds; fanout 1, 3 and 5; a world with no hot node;
   a dying world (fanout 1, churn 0.6; the plain run's restarts printed);
   patient zero in the first and last word with the call ending on a
   restart; and N=2^24, whose words outnumber the grid's threads;
2. K4 (rumor_hbm.cu) against its plain version, bit-equality of infected
   and hot (and infected fractions within 0.02): at N=2^24, churn 0 for 8
   rounds with both all_alive settings and churn 0.01 for 8 rounds; 1 and
   2 rounds with stop_k 3; fanout 1 and 3; a dying world (fanout 1, churn
   0.6, 200 rounds; the plain run's restarts printed); and N=2^26 for 8
   rounds, whose words outnumber the grid's threads;
3. the headline path: rumor_run(rumor_init(2^20, 0), 20000, 2^20, 2, 1,
   0.01, "fused"), one warm-up and three timed runs on fresh worlds; the
   infected fraction must lie in (0.55, 0.75) and K3 must have launched;
   then K3 alone on one call's inputs (ms a launch, us a round, its ratio
   to the bound), its round split into the barrier alone (a probe on the
   same grid), the loads and bit operations (churn 0) and the churn
   arithmetic left exposed;
4. the big-N path: rumor_run_hbm(..., block_rows=1024, all_alive=True) at
   N=2^24, 3000 rounds, churn 0.01, three timed runs on fresh worlds; same
   window, and one K4 launch a call; then the entry's host draws and K4
   alone on the last call's inputs (ms a launch, us a round, its ratio to
   the bound; bit-equal to the plain version over the 3000 rounds), its
   round split into the barrier alone (a probe on K4's grid), the loads
   and bit operations (churn 0) and the churn arithmetic left exposed;
   then one N=2^26 call of 1000 rounds (rounds/s, K4 us a round, bit-equal
   to the plain version, and the window if the plain run lies in it);
5. K1 (route_select.cu) against its plain version: bit-equality of the
   [n, c] output at (m = n = 2^20, c 2), (1000003, 2^18, 4), (2^20, 7, 3),
   (1, 1, 1) and all -1 targets;
6. the dense HyParView path on the card against the same path on the
   CPU at N=2^14: 30 rounds of run_dense at churn 0.01, then 2 blocks of
   run_dense_staggered(..., 0.01, 5); every leaf bit-equal;
7. the dense main path, perf_suite's hv_dense_1048576: N=2^20, the
   reference cadence (shuffle 10, promotion 5), k 5, churn 0.01,
   run_dense_staggered for 20 blocks (200 rounds), one warm-up and three
   timed trials from dense_init(cfg.replace(seed=11 + 13 t)); then 60
   churn-free run_dense rounds (the heal) and connectivity: every node
   live, reached/live >= 0.9999, mean_active >= min_active_size, and K1
   launched;
8. where the dense path's time goes: one call each of the heavy_ps,
   heavy_p and light programs, the [N] threefry draws of a round, K1
   against its plain version and torch.sort of the same keys, and a
   profiler window over one staggered block for the card's idle share;
10. K2 (bucket_pack.cu) against its plain version: bit-equality of tgt,
    order and dropped on [8, 2359296] shard ids with ~1/3 invalid (d 8,
    b 589824: the main path's shape), m = 1, all invalid, d = 1 and a
    tight b that drops; and K1 at the sharded route's shape (m =
    4718592, n = 786432, c = 6);
11. the sharded dense rounds (8 virtual shards) on the card against the
    CPU at N=2^14: hyparview 20 rounds at churn 0.01 on the main path's
    cadence, plumtree 10 rounds, scamp 20 rounds at churn 0.01, and 2
    blocks of run_sharded_staggered(k=5) on the default cadence; every
    leaf bit-equal;
12. the sharded main path, the reference's
    dense_scale_hyparview_n1048576x8_churn0p01 (scripts/
    dense_scale_suite.py:50-54): N=2^20 over 8 shards, shuffle 4,
    promotion 2, churn 0.01, the flat round; 4 warm-up and 40 settling
    rounds, then 3 timed windows of 20 rounds (median sharded dense
    rounds/s); then 40 churn-free rounds and the reference tests' gates
    (every node live, >= 0.99 with an active view, none isolated,
    symmetry >= 0.98, reached/live >= 0.999); K2 and K1 launched;
13. where a sharded round's time goes (CUDA events): the exchange (K2,
    scatter, transpose), the 8 K1 calls, the merge and the rest of the
    body; K2 on the main path's outbox and K1 on one shard's received
    rows, each against its bound, its plain version and torch.sort; a
    profiler window over one round (phases 10-13 print their host time);
9. (printed last) one JSON line of every ported kernel (launches, error
   against the plain version, times, bound), then the card's name and
   power limit, then the result line {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero with no result
line.  Without a CUDA device, or outside a checkout, it exits 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# 32-bit integer add, logic, shift and compare instructions an SM issues
# per clock at compute capability 9.0 (CUDA C++ Programming Guide, table of
# arithmetic instruction throughput); the kernels' operations are these.
INT32_OPS_PER_SM_CLOCK = 64

N_FUSED = 1 << 20
DYING = 0.6   # churn at fanout 1 that kills the rumor every few rounds
N_HBM = 1 << 24
N_HBM_BIG = 1 << 26
ENDEMIC = (0.55, 0.75)   # tests/test_rumor_kernel.py:52-55
N_DENSE = 1 << 20        # scripts/perf_suite.py:225-246, hv_dense_1048576
N_DENSE_CHECK = 1 << 14
REACHED = 0.9999         # results.csv:10: 1048560 of 1048576 reached
N_SHARDED = 1 << 20      # dense_scale_suite.py:50-54, the explicit arm
N_SHARDED_CHECK = 1 << 14
SHARDS = 8               # the reference's v5e-8 layout


def smi(query: str, fmt: str = "csv,noheader") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """The card's 32-bit integer issue rate: SMs x 64 x its top SM clock."""
    import torch
    mhz = float(smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_OPS_PER_SM_CLOCK * mhz * 1e6


def round_ops_per_word(fanout: int, stop_k: int, churn: float,
                       all_alive: bool) -> float:
    """32-bit integer operations one word of one round needs: the rolls,
    masks and updates of the round, and the mix32 chain of each packed
    Bernoulli mask (bitset.expansion gives its depth and set bits).  A
    mask's walk can stop once no bit of the word still ties p's prefix:
    level d + 1 is needed with probability 1 - (1 - 2^-d)^32, so a word
    needs the sum of those levels' costs (6.35 of 15 levels at p = 0.01),
    the least work any walk does."""
    from partisan_tpu_torch.ops.bitset import expansion

    def biased(p):
        depth, ones = expansion(p)
        return 1 + sum((1.0 - (1.0 - 2.0 ** -d) ** 32)
                       * (2 + 8 + (4 if ones >> d & 1 else 2))
                       for d in range(depth))

    alive_and = 0 if all_alive else 1
    ops = fanout * (3 + 1 + alive_and)   # roll, OR into hit, AND alive
    ops += alive_and + 2                 # send; new_inf = inf | hit & alive
    ops += 4 + 3 + 2                     # dup roll & send; new_hot; clear
    if stop_k > 1:
        ops += 1 + biased(1.0 / stop_k)
    if churn > 0.0:
        ops += 4 + biased(churn)
    return ops + 2                       # the hot & alive test


def bound_ms(bytes_moved: int, ops: float, ops_per_s: float
             ) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def route_ops(m: int, c: int) -> float:
    """32-bit integer operations reverse_select needs for m proposers:
    the pack (bounds test, select, mix32, shifts and the 64-bit compose,
    ~16 a row), the emit (bucket test and a look-back of up to c, ~6 + 2c
    a row), and the m log2(m) compare-and-move steps any comparison sort
    of the m 64-bit keys needs (~4 each)."""
    import math
    return m * (16 + 6 + 2 * c) + 4 * m * math.log2(max(m, 2))


def route_targets(m: int, n: int, seed: int, device):
    """[m] int32: 80% in [0, n), the rest -1 or just outside it."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = rng.integers(-2, n + 2, m)
    t = np.where(rng.random(m) < 0.8, t, -1).astype(np.int32)
    return torch.from_numpy(t).to(device)


def dense_phases(dev, card: str, int_rate: float) -> dict:
    """Phases 5-8: K1 against its plain version, the dense path on the
    card against the CPU, the N=2^20 main path and its breakdown.
    Returns K1's entry of the kernels line."""
    import numpy as np
    import torch
    from partisan_tpu_torch import prng
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.models import hyparview_dense as hd
    from partisan_tpu_torch.ops import route_kernel as rk

    # ---- 5. K1 against its plain version -------------------------------
    k1_err = 0
    for m, n, c in ((N_DENSE, N_DENSE, 2), (1000003, 1 << 18, 4),
                    (N_DENSE, 7, 3), (1, 1, 1), (9, 4, 2)):
        t = route_targets(m, n, m + n + c, dev)
        if (m, n, c) == (9, 4, 2):
            t = torch.full((m,), -1, dtype=torch.int32, device=dev)
        salt = 0x9E3779B9 ^ m
        want = rk.reverse_select_plain(t, salt, n, c)
        got = rk.reverse_select_cuda(t, salt, n, c)
        torch.cuda.synchronize()
        err = int((want.long() - got.long()).abs().max())
        k1_err = max(k1_err, err)
        print(f"[5] K1 vs plain, m={m} n={n} c={c}: max_abs_err {err}, "
              f"routed {int((got >= 0).sum())}")
        assert err == 0 and torch.equal(want, got), \
            "K1 disagrees with its plain version"

    # ---- 6. the dense path on the card against the CPU ------------------
    cfg = Config(n_nodes=N_DENSE_CHECK)
    leaves = []
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        s = hd.dense_init(cfg, device=d)
        s = hd.run_dense(s, 30, cfg, 0.01)
        s = hd.run_dense_staggered(s, 2, cfg, 0.01, 5)
        leaves.append(hd.state_to_numpy(s))
        print(f"[6] dense N=2^14, 30 + 20 rounds on {d}: "
              f"{time.perf_counter() - t0:.2f} s (host clock)")
    for f in ("active", "passive", "alive", "rnd", "partition"):
        same = np.array_equal(getattr(leaves[0], f), getattr(leaves[1], f))
        assert same, f"the dense path on the card differs from the CPU: {f}"
    print("[6] every leaf bit-equal between the card and the CPU")

    # ---- 7. the main path: hv_dense_1048576 ------------------------------
    cfg = Config(n_nodes=N_DENSE)
    blocks, k, churn = 20, 5, 0.01
    rounds = blocks * 2 * k

    def trial(seed):
        w0 = hd.dense_init(cfg.replace(seed=seed), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hd.run_dense_staggered(w0, blocks, cfg, churn, k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    rk.LAUNCHES = 0
    trial(cfg.seed)                                   # warm-up
    times = []
    for t in range(3):
        dt, out = trial(11 + 13 * t)
        times.append(dt)
    k1_launches = rk.LAUNCHES
    per_run = k1_launches // 4
    rps = rounds / statistics.median(times)
    print(f"[7] dense main path N=2^20, {rounds} rounds staggered k={k}, "
          f"churn {churn}: median {rps:.2f} rounds/s (host clock, {card}); "
          f"trials {[round(x, 3) for x in times]} s; K1 launches "
          f"{k1_launches} ({per_run} a run)")
    t0 = time.perf_counter()
    out = hd.run_dense(out, 60, cfg)
    h = {key: float(v) for key, v in hd.connectivity(out).items()}
    print(f"[7] after the 60-round heal ({time.perf_counter() - t0:.1f} s):"
          f" {json.dumps(h)}")
    assert h["live"] == N_DENSE, h
    assert h["reached"] / h["live"] >= REACHED, h
    assert h["mean_active"] >= cfg.min_active_size, h
    assert k1_launches > 0, "the dense main path did not launch K1"

    # ---- 8. where the dense path's time goes -----------------------------
    programs = dict(zip(("heavy_ps", "heavy_p", "light"),
                        hd.staggered_programs(cfg, churn, k)))
    rnd = int(out.rnd)
    prog_ms = {}
    for name, p in programs.items():
        p(out, rnd)
        torch.cuda.synchronize()
        prog_ms[name], _ = event_ms(lambda: p(out, rnd))
    key = prng.fold_in(prng.PRNGKey(cfg.seed ^ hd.ROUND_SEED), rnd)

    def draws():
        u = prng.uniform(prng.fold_in(key, 0), (N_DENSE,), device=dev)
        a = prng.randint(prng.fold_in(key, 1), (N_DENSE,), 0, N_DENSE,
                         device=dev)
        b = prng.randint(prng.fold_in(key, 40), (N_DENSE,), 0, N_DENSE,
                         device=dev)
        return u, a, b

    draws()
    draw_ms, _ = event_ms(draws)
    run_ms = statistics.median(times) * 1e3
    sum_ms = blocks * (prog_ms["heavy_ps"] + prog_ms["heavy_p"]
                       + 2 * (k - 1) * prog_ms["light"])
    print(f"[8] one call each at N=2^20 (CUDA events): heavy_ps "
          f"{prog_ms['heavy_ps']:.2f} ms, heavy_p {prog_ms['heavy_p']:.2f} "
          f"ms, light {prog_ms['light']:.2f} ms; x their counts in a run "
          f"{sum_ms:.0f} ms of {run_ms:.0f}")
    print(f"[8] the [N] threefry draws of a round (uniform + 2 randint): "
          f"{draw_ms:.2f} ms = {draw_ms / prog_ms['light']:.3f} of a light "
          f"round, {rounds * draw_ms / run_ms:.3f} of a run")

    t = route_targets(N_DENSE, N_DENSE, 1, dev)
    salt = 12345
    keys = rk.packed_keys(t, salt, N_DENSE)
    reps = 20
    timed = {}
    for name, fn in (("k1", lambda: rk.reverse_select_cuda(t, salt, N_DENSE,
                                                           2)),
                     ("plain", lambda: rk.reverse_select_plain(t, salt,
                                                               N_DENSE, 2)),
                     ("sort", lambda: torch.sort(keys, stable=True))):
        fn()
        torch.cuda.synchronize()
        total, _ = event_ms(lambda: [fn() for _ in range(reps)])
        timed[name] = total / reps
    # each input read once, each output written once: the targets and
    # [n, c]; the bitonic sort's 64-bit key traffic is scratch, not counted
    k1_bytes = N_DENSE * 4 + N_DENSE * 2 * 4
    k1_bound = bound_ms(k1_bytes, route_ops(N_DENSE, 2), int_rate)
    print(f"[8] K1 m=n=2^20 c=2: {timed['k1']:.4f} ms a call; plain "
          f"{timed['plain']:.4f} ms; torch.sort(stable) of the same keys "
          f"{timed['sort']:.4f} ms; bound {k1_bound[0] * 1e3:.2f} us by "
          f"{k1_bound[1]}; {per_run} calls a main-path run = "
          f"{per_run * timed['k1']:.1f} ms of {run_ms:.0f}")

    # the card's idle share over one staggered block (2k rounds): the
    # block's wall time without the profiler, then the kernels' busy time
    # in a profiled run of the same block
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    hd.run_dense_staggered(out, 1, cfg, churn, k)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hd.run_dense_staggered(out, 1, cfg, churn, k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if busy_ms > 0:
        print(f"[8] one block (2k rounds): {plain_wall_ms:.1f} ms wall "
              f"without the profiler; profiled: card busy {busy_ms:.1f} ms "
              f"of {wall_ms:.1f} ms wall, {sum(e.count for e in on_card)} "
              f"kernels; idle {1 - busy_ms / wall_ms:.3f} profiled, "
              f"{1 - busy_ms / plain_wall_ms:.3f} against the plain wall")
        top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            print(f"    {e.self_device_time_total / 1e3:8.2f} ms "
                  f"x{e.count:<5d} {e.key[:90]}")
    else:
        print("[8] profiler showed no device time: idle share not measured")

    return {"name": "route_select", "route": "cuda",
            "source": "partisan_tpu_torch/csrc/route_select.cu",
            "replaces": "partisan_tpu/ops/route_kernel.py:172",
            "launches": k1_launches, "max_abs_err": k1_err,
            "ms": timed["k1"], "plain_ms": timed["plain"],
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
            "library_ms": timed["sort"], "m": N_DENSE, "n": N_DENSE,
            "c": 2}


def bucket_ops(rows: int, d: int) -> float:
    """32-bit integer operations the bucket pack needs: per row the
    bucket test, the rank (count of earlier rows of its key) and the
    target, ~10 a row; plus a scan over the d + 1 bucket totals."""
    return 10.0 * rows + 4 * (d + 1)


def sharded_phases(dev, card: str, int_rate: float) -> dict:
    """Phases 10-13: K2 against its plain version (and one K1 case at the
    sharded route's shape), the sharded rounds on the card against the
    CPU, the N=2^20 x 8-shard main path and its breakdown.  Returns K2's
    entry of the kernels line and K1's launches and times on the sharded
    path (keys for K1's entry)."""
    import numpy as np
    import torch
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.models import hyparview_dense as hd
    from partisan_tpu_torch.ops import route_kernel as rk
    from partisan_tpu_torch.ops import shard_exchange as sx
    from partisan_tpu_torch.parallel import dense_dataplane as dd
    from partisan_tpu_torch.parallel import mesh as pm

    cfg = Config(n_nodes=N_SHARDED, shuffle_interval=4,
                 random_promotion_interval=2)
    n_loc = N_SHARDED // SHARDS
    slots = dd.hv_mail_slots(cfg)
    m_loc = n_loc * slots
    b_cap = sx.default_bucket_cap(m_loc, SHARDS)

    def phase_done(no: int, t_start: float) -> float:
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[{no}] phase took {now - t_start:.1f} s (host clock)")
        return now

    # ---- 10. K2 against its plain version ------------------------------
    t_phase = time.perf_counter()
    k2_err = 0
    for shape, d, b, invalid in (((SHARDS, m_loc), SHARDS, b_cap, 1 / 3),
                                 ((1,), 1, 1, 0.0),
                                 ((SHARDS, 4099), SHARDS, 16, 1.0),
                                 ((2, 100001), 1, 70000, 0.2),
                                 ((SHARDS, 100001), SHARDS, 3000, 0.1)):
        rng = np.random.default_rng(sum(shape) + d)
        s = rng.integers(0, d, shape)
        s = np.where(rng.random(shape) < invalid, d, s).astype(np.int32)
        s = torch.from_numpy(s).to(dev)
        want = rk.bucket_pack_plain(s, d, b)
        got = rk.bucket_pack_cuda(s, d, b)
        torch.cuda.synchronize()
        err = max(int((w.long() - g.long()).abs().max()) if w.numel() else 0
                  for w, g in zip(want, got))
        k2_err = max(k2_err, err)
        print(f"[10] K2 vs plain, shard ids {list(shape)}, d={d} b={b}, "
              f"{invalid:.2f} invalid: max_abs_err {err}, dropped "
              f"{got[2].tolist()}")
        assert err == 0 and all(torch.equal(w, g) for w, g in
                                zip(want, got)), \
            "K2 disagrees with its plain version"
    # K1 at the sharded route's shape: m = D*B received rows, n = 6 n_loc
    m_rt, n_rt = SHARDS * b_cap, dd.HV_KINDS * n_loc
    t = route_targets(m_rt, n_rt, 3, dev)
    want = rk.reverse_select_plain(t, 77, n_rt, 6)
    got = rk.reverse_select_cuda(t, 77, n_rt, 6)
    torch.cuda.synchronize()
    err = int((want.long() - got.long()).abs().max())
    print(f"[10] K1 vs plain at the route shape m={m_rt} n={n_rt} c=6: "
          f"max_abs_err {err}, routed {int((got >= 0).sum())}")
    assert err == 0, "K1 disagrees with its plain version"
    t_phase = phase_done(10, t_phase)

    # ---- 11. the sharded rounds on the card against the CPU -------------
    small = Config(n_nodes=N_SHARDED_CHECK, shuffle_interval=4,
                   random_promotion_interval=2)
    runs = (("hyparview", small, dict(churn=0.01), 20, dd.sharded_dense_init),
            ("plumtree", small, dict(model="plumtree"), 10,
             dd.sharded_pt_init),
            ("scamp", Config(n_nodes=N_SHARDED_CHECK),
             dict(model="scamp", churn=0.01), 20, dd.sharded_scamp_init),
            ("staggered", Config(n_nodes=N_SHARDED_CHECK), {}, 2,
             dd.sharded_dense_init))
    for name, c, kw, count, init in runs:
        leaves = []
        for d in ("cpu", dev):
            t0 = time.perf_counter()
            mesh = pm.make_mesh(SHARDS, d)
            st = init(c, SHARDS, device=d)
            if name == "staggered":
                st = dd.run_sharded_staggered(c, mesh, st, count, k=5)
            else:
                st = dd.run_sharded(dd.make_sharded_dense_round(c, mesh, **kw),
                                    st, count)
            leaves.append(flat_leaves(dd.state_to_numpy(st)))
            print(f"[11] sharded {name} N=2^14 D={SHARDS}, {count} "
                  f"{'blocks' if name == 'staggered' else 'rounds'} on {d}: "
                  f"{time.perf_counter() - t0:.2f} s (host clock)")
        for f in leaves[0]:
            assert np.array_equal(leaves[0][f], leaves[1][f]), \
                f"sharded {name} on the card differs from the CPU: {f}"
    print("[11] every leaf bit-equal between the card and the CPU")
    t_phase = phase_done(11, t_phase)

    # ---- 12. the main path: N=2^20 over 8 virtual shards -----------------
    mesh = pm.make_mesh(SHARDS, dev)
    step = dd.make_sharded_dense_round(cfg, mesh, churn=0.01)
    st = dd.sharded_dense_init(cfg, SHARDS, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rk.LAUNCHES = rk.PACK_LAUNCHES = 0
    rnd, trail = 0, []

    def rounds(st, count):
        nonlocal rnd
        for _ in range(count):
            st, mets = step(st, rnd)
            trail.append((mets["mail_sent"], mets["mail_dropped"]))
            rnd += 1
        return st

    st = rounds(st, 4)                      # warm-up
    st = rounds(st, 40)                     # settle
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = rounds(st, 20)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k1_launches, k2_launches = rk.LAUNCHES, rk.PACK_LAUNCHES
    rps = 20 / statistics.median(times)
    sent = [int(a) for a, _ in trail]
    dropped = [int(b) for _, b in trail]
    print(f"[12] sharded main path N=2^20 D={SHARDS}, churn 0.01, flat "
          f"round: median {rps:.3f} sharded dense rounds/s over rounds "
          f"44-103 (host clock, {card}); windows "
          f"{[round(x, 3) for x in times]} s; K2 launches {k2_launches}, "
          f"K1 launches {k1_launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"[12] mail sent per round {sent}")
    print(f"[12] mail dropped per round {dropped}")
    quiet = dd.make_sharded_dense_round(cfg, mesh)
    t0 = time.perf_counter()
    st = dd.run_sharded(quiet, st, 40)
    h = {key: float(v) for key, v in hd.connectivity(dd.to_dense(st)).items()}
    has_active = float((st.active >= 0).any(1).float().mean())
    print(f"[12] after 40 churn-free rounds ({time.perf_counter() - t0:.1f} "
          f"s): {json.dumps(h)}; non-empty active view {has_active:.6f}; "
          f"dropped per shard {st.dropped.tolist()}")
    assert h["live"] == N_SHARDED, h
    assert has_active >= 0.99, has_active
    assert h["isolated"] == 0, h
    assert h["symmetry"] >= 0.98, h
    assert h["reached"] / h["live"] >= 0.999, h
    assert k1_launches > 0 and k2_launches > 0, \
        "the sharded main path did not launch K1 and K2"
    t_phase = phase_done(12, t_phase)

    # ---- 13. where a sharded round's time goes ---------------------------
    rnd = int(st.rnd)
    churned = step
    no_merge = dd.make_sharded_dense_round(cfg, mesh, churn=0.01,
                                           skip=frozenset({"merge"}))
    reps = 5

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        total, _ = event_ms(lambda: [fn() for _ in range(reps)])
        return total / reps

    mail = st.mail.view(SHARDS, m_loc, -1)
    valid = mail[..., 0] != 0
    shard = torch.where(valid, mail[..., 1].clamp(0, N_SHARDED - 1) // n_loc,
                        SHARDS).to(torch.int32)
    recv, _ = sx.bucket_exchange(mail, n_loc, SHARDS, b_cap, mesh)
    base = torch.arange(SHARDS, dtype=torch.int32, device=dev)[:, None]
    dstl = (recv[..., 1] - base * n_loc).clamp(0, n_loc - 1)
    gdst = (dstl + base * n_loc).long()
    keep = (recv[..., 0] != 0) & st.alive[gdst] & (
        st.partition[gdst] == recv[..., 4])
    rkind = recv[..., 3]
    # K1 alone at the route shape: shard 0's received rows, keyed as
    # route_select keys them
    n_rt = dd.HV_KINDS * n_loc
    rt = torch.where(keep[0] & (rkind[0] >= 0) & (rkind[0] < dd.HV_KINDS),
                     rkind[0] * n_loc + dstl[0], -1).to(torch.int32)
    rt_keys = rk.packed_keys(rt, 12345, n_rt)
    ms = {
        "round": timed(lambda: churned(st, rnd)),
        "round_no_merge": timed(lambda: no_merge(st, rnd)),
        "exchange": timed(lambda: sx.bucket_exchange(mail, n_loc, SHARDS,
                                                     b_cap, mesh)),
        "route": timed(lambda: sx.route_select(rkind, dstl, keep,
                                               dd.HV_KINDS, n_loc, 6, 12345)),
        "k2": timed(lambda: rk.bucket_pack_cuda(shard, SHARDS, b_cap)),
        "k2_plain": timed(lambda: rk.bucket_pack_plain(shard, SHARDS,
                                                       b_cap)),
        "k2_sort": timed(lambda: torch.sort(shard, dim=-1, stable=True)),
        "k1": timed(lambda: rk.reverse_select_cuda(rt, 12345, n_rt, 6)),
        "k1_plain": timed(lambda: rk.reverse_select_plain(rt, 12345, n_rt,
                                                          6)),
        "k1_sort": timed(lambda: torch.sort(rt_keys, stable=True)),
    }
    ms["merge"] = ms["round"] - ms["round_no_merge"]
    ms["body"] = ms["round"] - ms["exchange"] - ms["route"] - ms["merge"]
    want = rk.bucket_pack_plain(shard, SHARDS, b_cap)
    got = rk.bucket_pack_cuda(shard, SHARDS, b_cap)
    err = max(int((w.long() - g.long()).abs().max()) for w, g in
              zip(want, got))
    assert err == 0, "K2 disagrees with its plain version on the outbox"
    k2_err = max(k2_err, err)
    k2_bound = bound_ms(SHARDS * m_loc * 12 + SHARDS * 4,
                        bucket_ops(SHARDS * m_loc, SHARDS), int_rate)
    print(f"[13] one sharded round at N=2^20 (CUDA events, {reps} calls "
          f"each): {ms['round']:.2f} ms = exchange {ms['exchange']:.2f} "
          f"(K2 {ms['k2']:.3f}, scatter + transpose "
          f"{ms['exchange'] - ms['k2']:.2f}) + route ({SHARDS} K1 calls) "
          f"{ms['route']:.2f} + merge {ms['merge']:.2f} + body "
          f"{ms['body']:.2f}")
    print(f"[13] K2 on the main path's outbox [{SHARDS}, {m_loc}], d="
          f"{SHARDS} b={b_cap}: {ms['k2']:.4f} ms a call; plain "
          f"{ms['k2_plain']:.4f} ms; torch.sort(stable) of the same keys "
          f"{ms['k2_sort']:.4f} ms; bound {k2_bound[0] * 1e3:.2f} us by "
          f"{k2_bound[1]}; max_abs_err {err}")
    k1_bound = bound_ms(m_rt * 4 + n_rt * 6 * 4, route_ops(m_rt, 6), int_rate)
    print(f"[13] K1 at the route shape m={m_rt} n={n_rt} c=6 (shard 0's "
          f"mailbox): {ms['k1']:.4f} ms a call; plain {ms['k1_plain']:.4f} "
          f"ms; torch.sort(stable) of the same keys {ms['k1_sort']:.4f} ms; "
          f"bound {k1_bound[0] * 1e3:.2f} us by {k1_bound[1]}; "
          f"{SHARDS} calls a round = {SHARDS * ms['k1']:.2f} ms")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    churned(st, rnd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    churned(st, rnd)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        churned(st, rnd)
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if busy_ms > 0:
        print(f"[13] one round: {plain_wall_ms:.1f} ms wall without the "
              f"profiler; card busy {busy_ms:.1f} ms in a profiled round, "
              f"{sum(e.count for e in on_card)} kernels; idle "
              f"{1 - busy_ms / plain_wall_ms:.3f} against the plain wall")
        top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            print(f"    {e.self_device_time_total / 1e3:8.2f} ms "
                  f"x{e.count:<5d} {e.key[:90]}")
    else:
        print("[13] profiler showed no device time: idle share not measured")
    phase_done(13, t_phase)

    return {"name": "bucket_pack", "route": "cuda",
            "source": "partisan_tpu_torch/csrc/bucket_pack.cu",
            "replaces": "partisan_tpu/ops/route_kernel.py:216",
            "launches": k2_launches, "max_abs_err": k2_err,
            "ms": ms["k2"], "plain_ms": ms["k2_plain"],
            "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
            "library_ms": ms["k2_sort"], "shards": SHARDS, "m": m_loc,
            "d": SHARDS, "b": b_cap}, {
        "sharded_launches": k1_launches, "sharded_ms": ms["k1"],
        "sharded_plain_ms": ms["k1_plain"], "sharded_bound_ms": k1_bound[0],
        "sharded_bound_by": k1_bound[1], "sharded_library_ms": ms["k1_sort"],
        "sharded_m": m_rt, "sharded_n": n_rt, "sharded_c": 6}


def flat_leaves(state) -> dict:
    """{name: numpy array} of a sharded state from ``state_to_numpy``."""
    out = {}
    for f in type(state)._fields:
        x = getattr(state, f)
        if f == "hv":
            out.update({f"hv.{k}": v for k, v in flat_leaves(x).items()})
        else:
            out[f] = x
    return out


def max_abs_err(a, b) -> int:
    """Largest difference of two int32 word tensors read as uint32."""
    mask = 0xFFFFFFFF
    return int(((a.long() & mask) - (b.long() & mask)).abs().max())


def event_ms(fn) -> tuple[float, object]:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def random_packed(n: int, seed: int, dead: bool, device):
    """A packed world with ~20% infected, ~half of them hot and, when
    ``dead``, ~1/8 of the nodes dead; made from a numpy seed."""
    import numpy as np
    import torch
    from partisan_tpu_torch.models.demers import RumorWorldPacked
    rng = np.random.default_rng(seed)
    w = n // 32

    def words(k, op):
        acc = rng.integers(0, 2 ** 32, w, dtype=np.uint64).astype(np.uint32)
        for _ in range(k - 1):
            acc = op(acc, rng.integers(0, 2 ** 32, w, dtype=np.uint64)
                     .astype(np.uint32))
        return acc

    inf = words(2, np.bitwise_and) & ~words(3, np.bitwise_and)
    hot = inf & words(1, np.bitwise_and)
    alive = (words(3, np.bitwise_or) if dead
             else np.full(w, 0xFFFFFFFF, np.uint32))
    t = [torch.from_numpy(x.view(np.int32)).to(device)
         for x in (inf, hot, alive)]
    return RumorWorldPacked(*t, torch.zeros((), dtype=torch.int32,
                                            device=device))


def k3_cases(dev):
    """Phase 1's K3 cases: (label, world, table, stop_k, churn)."""
    import torch
    from partisan_tpu_torch.models import demers
    from partisan_tpu_torch.ops import rumor_kernel as rk
    n = N_FUSED

    def table(w, rounds, fanout, n=n):
        return rk.rumor_table(int(w.rnd), rounds, n, fanout)

    init = demers.rumor_pack(demers.rumor_init(n, 5, device=dev))
    rand = random_packed(n, 1, True, dev)
    cold = rand._replace(hot=torch.zeros_like(rand.hot))
    yield "rumor_init(n, 5), stop_k 1", init, table(init, 64, 2), 1, 0.01
    yield "random world, stop_k 3", rand, table(rand, 64, 2), 3, 0.01
    small = random_packed(4096, 3, True, dev)
    yield ("N=4096 (one row: 128 words, fewer than a block's threads), 61 "
           "rounds, stop_k 3", small, table(small, 61, 2, 4096), 3, 0.01)
    for rounds in (1, 2):
        yield (f"{rounds} round(s), stop_k 3", rand, table(rand, rounds, 2),
               3, 0.01)
    for fanout in (1, 3, 5):
        yield f"fanout {fanout}", rand, table(rand, 64, fanout), 1, 0.01
    yield "no hot node (round 0 restarts)", cold, table(cold, 64, 2), 1, 0.01
    yield (f"dying world: fanout 1, churn {DYING}, 200 rounds", rand,
           table(rand, 200, 1), 1, DYING)
    # patient zero in word 0 on even rounds, in the last word on odd ones;
    # the call ends on its last restart, which the epilogue applies
    ends = table(rand, 200, 1)
    ends[0::2, -1] = torch.arange(0, 200, 2) % 32
    ends[1::2, -1] = n - 1 - torch.arange(1, 200, 2) % 32
    died = []
    rk.rumor_run_fused_plain(rand, ends, n, 1, DYING, died)
    assert {0, 1} <= {d % 2 for d in died}, died
    yield (f"patient zero in the first and last word, ends on a restart "
           f"(round {died[-1]})", rand, ends[:died[-1] + 1], 1, DYING)
    big = random_packed(N_HBM, 4, True, dev)
    yield ("N=2^24 (more words than the grid's threads), stop_k 3", big,
           table(big, 8, 2, N_HBM), 3, 0.01)


def k4_cases(dev):
    """Phase 2's K4 cases: (label, world, table, stop_k, churn,
    all_alive)."""
    from partisan_tpu_torch.ops import rumor_kernel_hbm as hbm
    n = N_HBM

    def table(w, rounds, fanout, n=n):
        return hbm.hbm_table(int(w.rnd), rounds, n, fanout)

    for all_alive, churn in ((False, 0.0), (True, 0.0), (True, 0.01)):
        w = random_packed(n, 2, not all_alive, dev)
        yield "stop_k 1", w, table(w, 8, 2), 1, churn, all_alive
    rand = random_packed(n, 5, True, dev)
    for rounds in (1, 2):
        yield "stop_k 3", rand, table(rand, rounds, 2), 3, 0.01, False
    for fanout in (1, 3):
        yield (f"fanout {fanout}, stop_k 3", rand, table(rand, 64, fanout), 3,
               0.01, False)
    yield ("dying world: fanout 1", rand, table(rand, 200, 1), 1, DYING,
           False)
    big = random_packed(N_HBM_BIG, 6, True, dev)
    yield ("N=2^26 (more words than the grid's threads), stop_k 3", big,
           table(big, 8, 2, N_HBM_BIG), 3, 0.01, False)


def k3_times(fn, reps: int = 3) -> list[float]:
    """``reps`` CUDA-event times (ms) of fn, one call each."""
    return [event_ms(fn)[0] for _ in range(reps)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "partisan_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from partisan_tpu_torch.models import demers
    from partisan_tpu_torch.ops import _native, bitset, rumor_kernel
    from partisan_tpu_torch.ops import rumor_kernel_hbm as hbm

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    int_rate = int32_ops_per_s()
    print(f"[0] card: {card}")
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; int32 issue rate "
          f"{int_rate / 1e12:.2f} TOP/s")
    t0 = time.perf_counter()
    _native.lib()
    print(f"[0] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ({_native.BUILD['path']})")
    for line in _native.BUILD["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            print(f"    {line.strip()}")

    def frac(words, n):
        return bitset.count(words) / n

    # ---- 1. K3 against its plain version -------------------------------
    k3_err = 0
    for label, w, table, stop_k, churn in k3_cases(dev):
        n = w.infected.shape[0] * 32
        died = []
        want = rumor_kernel.rumor_run_fused_plain(w, table, n, stop_k, churn,
                                                  died)
        got = rumor_kernel.rumor_run_fused_cuda(w, table, n, stop_k, churn)
        torch.cuda.synchronize()
        err = max(max_abs_err(want.infected, got.infected),
                  max_abs_err(want.hot, got.hot))
        k3_err = max(k3_err, err)
        print(f"[1] K3 vs plain, N={n}, {table.shape[0]} rounds, churn "
              f"{churn}, {label}: max_abs_err {err}, infected "
              f"{frac(got.infected, n):.4f}, restarts in the plain run "
              f"{len(died)}")
        assert err == 0, "K3 disagrees with its plain version"

    # ---- 2. K4 against its plain version -------------------------------
    k4_err = 0
    for label, w, table, stop_k, churn, all_alive in k4_cases(dev):
        n = w.infected.shape[0] * 32
        died = []
        want = hbm.rumor_run_hbm_plain(w, table, n, stop_k, churn, all_alive,
                                       died)
        got = hbm.rumor_run_hbm_cuda(w, table, n, stop_k, churn, all_alive)
        torch.cuda.synchronize()
        err = max(max_abs_err(want.infected, got.infected),
                  max_abs_err(want.hot, got.hot))
        k4_err = max(k4_err, err)
        fw, fg = frac(want.infected, n), frac(got.infected, n)
        print(f"[2] K4 vs plain, N={n}, {table.shape[0]} rounds, churn "
              f"{churn}, all_alive {all_alive}, {label}: max_abs_err {err}, "
              f"infected {fg:.4f} (plain {fw:.4f}), restarts in the plain "
              f"run {len(died)}")
        assert abs(fw - fg) <= 0.02, "K4 infected fraction off its plain"
        assert err == 0, "K4 disagrees with its plain version"

    # ---- 3. the headline path: K3 inside rumor_run ---------------------
    n, rounds = N_FUSED, 20000

    def headline(pz):
        out = demers.rumor_run(demers.rumor_init(n, pz, device=dev), rounds,
                               n, 2, 1, 0.01, "fused")
        torch.cuda.synchronize()
        return out

    rumor_kernel.LAUNCHES = 0
    headline(0)                                       # warm-up
    times, fracs = [], []
    for t in range(3):
        t0 = time.perf_counter()
        out = headline(104729 * (t + 3) % n)
        times.append(time.perf_counter() - t0)
        fracs.append(float(out.infected.float().mean()))
    k3_launches = rumor_kernel.LAUNCHES
    rps = rounds / statistics.median(times)
    print(f"[3] headline N=2^20, {rounds} rounds, churn 0.01: median "
          f"{rps:.1f} rounds/s (host clock, {card}); infected {fracs}; "
          f"K3 launches {k3_launches}")
    assert all(ENDEMIC[0] < f < ENDEMIC[1] for f in fracs), fracs
    assert k3_launches > 0, "the headline path did not launch K3"
    # K3 alone, its plain version and its parts on one headline call's
    # inputs (CUDA events, three launches each, median)
    w = demers.rumor_pack(demers.rumor_init(n, 0, device=dev))
    t0 = time.perf_counter()
    table = rumor_kernel.rumor_table(0, rounds, n, 2)
    draw_ms = (time.perf_counter() - t0) * 1e3

    def k3(churn):
        return lambda: rumor_kernel.rumor_run_fused_cuda(w, table, n, 1,
                                                         churn)

    k3_all = k3_times(k3(0.01))
    k3_ms = statistics.median(k3_all)
    k3_plain_ms, _ = event_ms(lambda: rumor_kernel.rumor_run_fused_plain(
        w, table, n, 1, 0.01))
    W = n // 32
    k3_bound = bound_ms(5 * W * 4 + table.numel() * 4,
                        rounds * W * round_ops_per_word(2, 1, 0.01, False),
                        int_rate)
    call_ms = statistics.median(times) * 1e3
    us = 1e3 / rounds
    launches = [round(x, 3) for x in k3_all]
    print(f"[3] K3 one launch of {rounds} rounds: {k3_ms:.3f} ms "
          f"({k3_ms * us:.4f} us/round; launches {launches} ms); "
          f"{k3_ms / k3_bound[0]:.2f}x its bound {k3_bound[0]:.4f} ms by "
          f"{k3_bound[1]}; plain {k3_plain_ms:.1f} ms; host draws of the "
          f"table {draw_ms:.1f} ms; card idle {1.0 - k3_ms / call_ms:.3f} "
          f"of a {call_ms:.1f} ms call ({card})")
    calm = statistics.median(k3_times(k3(0.0)))
    barrier = statistics.median(k3_times(
        lambda: rumor_kernel.barrier_probe_cuda(rounds, n, 2)))
    print(f"[3] without churn: K3 {calm * us:.4f} us/round (with churn "
          f"{k3_ms * us:.4f}); the barrier alone {barrier * us:.4f} "
          f"us/round ({card})")
    print(f"[3] K3 a round: {k3_ms * us:.4f} us = the barrier alone "
          f"{barrier * us:.4f} + loads and bit operations "
          f"{(calm - barrier) * us:.4f} + churn arithmetic left exposed "
          f"{(k3_ms - calm) * us:.4f} ({card})")

    # ---- 4. the big-N path: K4 through its entry point -----------------
    n, rounds = N_HBM, 3000
    worlds = [demers.rumor_pack(demers.rumor_init(
        n, 104729 * (t + 3) % n, device=dev)) for t in range(3)]
    torch.cuda.synchronize()
    hbm.LAUNCHES = 0
    times, spans, fracs = [], [], []
    for w in worlds:
        t0 = time.perf_counter()
        span, out = event_ms(lambda: hbm.rumor_run_hbm(
            w, rounds, n, 2, 1, 0.01, 1024, True))
        times.append(time.perf_counter() - t0)
        spans.append(span)
        fracs.append(frac(out.infected, n))
    k4_launches = hbm.LAUNCHES
    rps = rounds / statistics.median(times)
    print(f"[4] big-N rumor_run_hbm N=2^24, {rounds} rounds, churn 0.01, "
          f"block_rows 1024, all_alive: median {rps:.1f} rounds/s (host "
          f"clock); call spans {[round(s, 3) for s in spans]} ms (CUDA "
          f"events); infected {fracs}; K4 launches {k4_launches}")
    assert all(ENDEMIC[0] < f < ENDEMIC[1] for f in fracs), fracs
    assert k4_launches == len(worlds), \
        "the big-N path did not make one K4 launch a call"
    # the entry's parts on the last call's inputs: the host draws, and K4
    # alone on the table they give (CUDA events, three launches each,
    # median), held against its plain version over the whole call
    t0 = time.perf_counter()
    table = hbm.hbm_table(int(w.rnd), rounds, n, 2)
    draw_ms = (time.perf_counter() - t0) * 1e3

    def k4(churn, w=w, table=table, n=n):
        return lambda: hbm.rumor_run_hbm_cuda(w, table, n, 1, churn, True)

    k4_all = k3_times(k4(0.01))
    k4_ms = statistics.median(k4_all)
    k4_plain_ms, want = event_ms(lambda: hbm.rumor_run_hbm_plain(
        w, table, n, 1, 0.01, True))
    got = k4(0.01)()
    torch.cuda.synchronize()
    err = max(max_abs_err(want.infected, got.infected),
              max_abs_err(want.hot, got.hot))
    k4_err = max(k4_err, err)
    assert err == 0, "K4 disagrees with its plain version on the main path"
    W = n // 32
    k4_bound = bound_ms(4 * W * 4 + table.numel() * 4,
                        rounds * W * round_ops_per_word(2, 1, 0.01, True),
                        int_rate)
    call_ms = statistics.median(spans)
    us = 1e3 / rounds
    print(f"[4] K4 one launch of {rounds} rounds: {k4_ms:.3f} ms "
          f"({k4_ms * us:.4f} us/round; launches "
          f"{[round(x, 3) for x in k4_all]} ms); {k4_ms / k4_bound[0]:.2f}x "
          f"its bound {k4_bound[0]:.4f} ms by {k4_bound[1]}; plain "
          f"{k4_plain_ms:.1f} ms (max_abs_err {err}); host draws of the "
          f"table {draw_ms:.1f} ms; card idle {1.0 - k4_ms / call_ms:.3f} "
          f"of a {call_ms:.1f} ms call span ({card})")
    calm = statistics.median(k3_times(k4(0.0)))
    barrier = statistics.median(k3_times(
        lambda: hbm.barrier_probe_cuda(rounds, n)))
    print(f"[4] K4 a round: {k4_ms * us:.4f} us = the barrier alone "
          f"{barrier * us:.4f} + loads and bit operations "
          f"{(calm - barrier) * us:.4f} + churn arithmetic left exposed "
          f"{(k4_ms - calm) * us:.4f} ({card})")

    # one N=2^26 call of 1000 rounds through the entry point
    n, rounds = N_HBM_BIG, 1000
    w = demers.rumor_pack(demers.rumor_init(n, 104729 % n, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = hbm.rumor_run_hbm(w, rounds, n, 2, 1, 0.01, 1024, True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    table = hbm.hbm_table(int(w.rnd), rounds, n, 2)
    big_ms = statistics.median(k3_times(k4(0.01, w, table, n)))
    want = hbm.rumor_run_hbm_plain(w, table, n, 1, 0.01, True)
    err = max(max_abs_err(want.infected, out.infected),
              max_abs_err(want.hot, out.hot))
    k4_err = max(k4_err, err)
    W = n // 32
    big_bound = bound_ms(4 * W * 4 + table.numel() * 4,
                         rounds * W * round_ops_per_word(2, 1, 0.01, True),
                         int_rate)
    fk, fp = frac(out.infected, n), frac(want.infected, n)
    print(f"[4] big-N rumor_run_hbm N=2^26, {rounds} rounds, churn 0.01, "
          f"all_alive: {rounds / dt:.1f} rounds/s (host clock, one call); "
          f"K4 {big_ms:.3f} ms a launch ({big_ms * 1e3 / rounds:.4f} "
          f"us/round), {big_ms / big_bound[0]:.2f}x its bound "
          f"{big_bound[0]:.4f} ms by {big_bound[1]}; infected {fk:.4f} "
          f"(plain {fp:.4f}, max_abs_err {err}) ({card})")
    assert err == 0, "K4 disagrees with its plain version at N=2^26"
    if ENDEMIC[0] < fp < ENDEMIC[1]:
        assert ENDEMIC[0] < fk < ENDEMIC[1], fk

    route = dense_phases(dev, card, int_rate)
    pack, route_sharded = sharded_phases(dev, card, int_rate)
    route.update(route_sharded)

    # ---- 9. the kernels line, the card, the result ---------------------
    kernels = [
        {"name": "rumor_fused", "route": "cuda",
         "source": "partisan_tpu_torch/csrc/rumor_fused.cu",
         "replaces": "partisan_tpu/ops/rumor_kernel.py:180",
         "launches": k3_launches, "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": None, "n": N_FUSED, "rounds": 20000},
        {"name": "rumor_hbm", "route": "cuda",
         "source": "partisan_tpu_torch/csrc/rumor_hbm.cu",
         "replaces": "partisan_tpu/ops/rumor_kernel_hbm.py:448",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": None, "n": N_HBM, "rounds": 3000},
        route,
        pack,
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
