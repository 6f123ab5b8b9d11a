#!/usr/bin/env python3
"""Time the port's K4 kernel (``partisan_tpu_torch/csrc/rumor_hbm.cu``)
from several source trees in one run on one card, in the order given.

    python3 scripts/k4_compare.py TREE [TREE ...]

Each TREE is a directory holding a ``partisan_tpu_torch/`` package: a
checkout, or a ``git archive`` of another commit unpacked into a directory
that ``.gitignore`` lists.  Name a tree twice to alternate (parent,
change, change, parent).  Each tree runs in a process of its own, which
builds that tree's kernels, compares its K4 with its plain version over 8
rounds at N=2^24 (bit for bit: "equal" in its line; a tree whose kernel
leaves out a part on purpose, to time the rest, is not), and then times,
with CUDA events (three launches each, median):

- K4 on the big-N call: N=2^24, 3000 rounds, fanout 2, stop_k 1, churn
  0.01, all_alive, on the table the entry point draws from
  ``rumor_init(2^24, 0)``; then the same without churn;
- K4's barrier probe on its own grid, where the tree has one;
- K4 at N=2^26 for 1000 rounds, churn 0.01;
- the entry point ``rumor_run_hbm`` at 2^24 (host clock, one call).

It prints one JSON line a tree, and the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from partisan_tpu_torch.models import demers
from partisan_tpu_torch.ops import _native
from partisan_tpu_torch.ops import rumor_kernel_hbm as hbm

def event_ms(fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record(); fn(); b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b)

def med(fn):
    fn(); torch.cuda.synchronize()
    return statistics.median(event_ms(fn) for _ in range(3))

dev = torch.device("cuda")
t0 = time.perf_counter()
_native.lib()
out = {"tree": sys.argv[1], "build_s": time.perf_counter() - t0}
n = 1 << 24
w = demers.rumor_pack(demers.rumor_init(n, 0, device=dev))
check = hbm.hbm_table(int(w.rnd), 8, n, 2)
want = hbm.rumor_run_hbm_plain(w, check, n, 1, 0.01, True)
got = hbm.rumor_run_hbm_cuda(w, check, n, 1, 0.01, True)
out["equal"] = bool(torch.equal(want.infected, got.infected)
                    and torch.equal(want.hot, got.hot))
table = hbm.hbm_table(int(w.rnd), 3000, n, 2)
out["k4_ms"] = med(lambda: hbm.rumor_run_hbm_cuda(w, table, n, 1, 0.01,
                                                  True))
out["k4_calm_ms"] = med(lambda: hbm.rumor_run_hbm_cuda(w, table, n, 1, 0.0,
                                                       True))
if hasattr(hbm, "barrier_probe_cuda"):
    out["barrier_ms"] = med(lambda: hbm.barrier_probe_cuda(3000, n))
big = 1 << 26
wb = demers.rumor_pack(demers.rumor_init(big, 0, device=dev))
tb = hbm.hbm_table(int(wb.rnd), 1000, big, 2)
out["k4_2p26_ms"] = med(lambda: hbm.rumor_run_hbm_cuda(wb, tb, big, 1, 0.01,
                                                       True))
torch.cuda.synchronize()
t0 = time.perf_counter()
hbm.rumor_run_hbm(w, 3000, n, 2, 1, 0.01, 1024, True)
torch.cuda.synchronize()
out["entry_rounds_per_s"] = 3000 / (time.perf_counter() - t0)
out["us_per_round"] = out["k4_ms"] / 3000 * 1e3
print(json.dumps(out))
"""


def main() -> int:
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    rows = []
    for tree in trees:
        run = subprocess.run([sys.executable, "-c", CHILD, tree],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    by_tree = {}
    for r in rows:
        by_tree.setdefault(r["tree"], []).append(r["us_per_round"])
    for tree, us in by_tree.items():
        print(f"{tree}: K4 us a round at 2^24 {us} (median "
              f"{statistics.median(us):.4f})")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
