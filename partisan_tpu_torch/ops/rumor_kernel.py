"""K3: the whole rumor-mongering run in one launch — the counterpart of
``partisan_tpu/ops/rumor_kernel.py::rumor_run_fused``.

The TPU kernel drew its per-round randomness from the on-core PRNG, whose
bits no other machine can replay.  This one takes the per-round scalars
exactly as the packed reference draws them (``models.demers.rumor_draws``:
shifts, coin and churn salts, patient zero), in one vectorised host pass,
and computes the packed Bernoulli masks in its body.  So it is bit-exact
with ``rumor_run(..., variant="packed")`` at every stop_k and churn.

The kernel is ``csrc/rumor_fused.cu``: a persistent cooperative grid with
one split-phase grid barrier a round, whose barrier word also carries the
"any sender left" count, so a restart is applied when the next round loads
patient zero's word.  ``rumor_run_fused`` launches it for a CUDA tensor and
runs the plain version (the packed round applied to the same table,
``rumor_run_fused_plain``) for a CPU tensor; there is no fallback from one
to the other.
"""

from __future__ import annotations

import torch

from ..models.demers import RumorWorldPacked, rumor_run_packed, rumor_table
from . import _native
from .bitset import WORD, expansion

LANES = 128
CELL = LANES * WORD  # nodes per 128-word row

LAUNCHES = 0   # kernel launches; chip_smoke.py resets and reads it

# The plain version: the packed scan over the same drawn table.
rumor_run_fused_plain = rumor_run_packed


def mask_args(stop_k: int, churn: float):
    """(coin depth, coin ones, churn depth, churn ones); depth 0 = off."""
    coin = expansion(1.0 / stop_k) if stop_k > 1 else (0, 0)
    reborn = expansion(churn) if churn > 0.0 else (0, 0)
    return (*coin, *reborn)


def check_packed(packed: RumorWorldPacked, n: int, n_rounds: int) -> None:
    """The kernels' contract: n a multiple of 4096, at least one round,
    and three contiguous int32 [n/32] word tensors on one device."""
    if n % CELL != 0:
        raise ValueError(f"n must be a multiple of {CELL}, got {n}")
    if n_rounds < 1:
        raise ValueError(f"a run has at least one round, got {n_rounds}")
    dev = packed.infected.device
    for name in ("infected", "hot", "alive"):
        t = getattr(packed, name)
        if t.dtype != torch.int32 or t.shape != (n // WORD,):
            raise ValueError(f"{name}: want int32 [{n // WORD}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: want contiguous on {dev}")


def check_table(table: torch.Tensor, per_fanout: int) -> int:
    """A drawn table is int32 [rounds, per_fanout * fanout + 3] with
    fanout >= 1; returns the fanout.  The kernels read it through a raw
    pointer, so anything else would be misread."""
    ok = (table.dtype == torch.int32 and table.dim() == 2
          and table.shape[1] >= per_fanout + 3
          and (table.shape[1] - 3) % per_fanout == 0)
    if not ok:
        raise ValueError(f"table: want int32 [rounds, {per_fanout}*fanout "
                         f"+ 3], got {table.dtype} {tuple(table.shape)}")
    return (table.shape[1] - 3) // per_fanout


def rumor_run_fused_cuda(packed: RumorWorldPacked, table: torch.Tensor,
                         n: int, stop_k: int, churn: float
                         ) -> RumorWorldPacked:
    """One launch of ``csrc/rumor_fused.cu`` over the whole table: a
    thread a word in blocks of 256, capped at what the card holds at once
    (128 blocks at n = 2^20)."""
    global LAUNCHES
    fanout = check_table(table, 1)
    n_rounds = table.shape[0]
    check_packed(packed, n, n_rounds)
    dev = packed.infected.device
    if dev.type != "cuda":
        raise ValueError(f"the K3 kernel runs on a CUDA tensor, got {dev}")
    W = n // WORD
    table = table.to(dev).contiguous()
    inf = torch.empty((2, W), dtype=torch.int32, device=dev)
    hot = torch.empty((2, W), dtype=torch.int32, device=dev)
    inf[0].copy_(packed.infected)
    hot[0].copy_(packed.hot)
    counts = torch.zeros(n_rounds, dtype=torch.int32, device=dev)
    lib = _native.lib()
    err = lib.rumor_fused_run(
        table.data_ptr(), n_rounds, fanout, n, *mask_args(stop_k, churn),
        packed.alive.data_ptr(), inf.data_ptr(), hot.data_ptr(),
        counts.data_ptr(), _native.stream_handle(inf))
    _native.check(err, "rumor_fused_run")
    LAUNCHES += 1
    slot = n_rounds % 2
    return RumorWorldPacked(inf[slot], hot[slot], packed.alive,
                            packed.rnd + n_rounds)


def barrier_probe_cuda(n_rounds: int, n: int, fanout: int = 2,
                       device="cuda") -> None:
    """K3's grid barrier alone: ``n_rounds`` arrive-and-wait rounds on the
    grid ``rumor_run_fused_cuda`` takes for (n, fanout).  A timing probe
    for the share of a round that is the barrier; it computes nothing and
    counts no launch."""
    counts = torch.zeros(n_rounds, dtype=torch.int32, device=device)
    err = _native.lib().rumor_barrier_run(n_rounds, n, fanout,
                                          counts.data_ptr(),
                                          _native.stream_handle(counts))
    _native.check(err, "rumor_barrier_run")


def rumor_run_fused(packed: RumorWorldPacked, n_rounds: int, n: int,
                    fanout: int = 2, stop_k: int = 1, churn: float = 0.0
                    ) -> RumorWorldPacked:
    """Run ``n_rounds`` of rumor mongering in one kernel launch.

    ``packed`` holds int32 words; ``n`` must be a multiple of 4096 (for the
    10^6-node benchmark, n = 2^20).  Returns the same type, on the same
    device: the kernel for a CUDA tensor, the plain version for a CPU one.
    """
    check_packed(packed, n, n_rounds)
    table = rumor_table(int(packed.rnd), n_rounds, n, fanout)
    if packed.infected.is_cuda:
        return rumor_run_fused_cuda(packed, table, n, stop_k, churn)
    return rumor_run_fused_plain(packed, table, n, stop_k, churn)
