"""K4: the rumor epidemic with state in device memory, one launch a
call — the counterpart of ``partisan_tpu/ops/rumor_kernel_hbm.py::
rumor_run_hbm``, the big-N path (2^24 and 2^26 nodes).

State is viewed as [R, 128] words, R = n / 4096.  Per (round, fanout) the
partner permutation is a row translation q over all R rows composed with
an intra-row bit rotation r in [1, 4096); q, r, the patient zeros and the
round seeds are drawn as ``rumor_run_hbm`` draws them, from
``fold_in(PRNGKey(0xB10C), rnd)`` split 4.  The restart reseed comes one
round late, from the previous round's hot count, and never on a call's
first round.  ``all_alive=True`` (caller-asserted) treats every node as
alive and reads no alive word.

The TPU kernel's churn and coin bits came from its on-core PRNG; here a
counter-based generator keyed by (round seed, round, word) feeds the same
bit-serial Bernoulli expansion (``bitset.biased_words`` with a per-round
salt).  Kernel and plain version share it, so they agree bit for bit at
any churn; against the reference the run is exact at churn 0 and
distributional above it.

``rumor_run_hbm`` launches ``csrc/rumor_hbm.cu`` for a CUDA tensor and
runs the plain version (``rumor_run_hbm_plain``) for a CPU one.  The
kernel is a persistent cooperative grid that runs every round of the call
with one split-phase grid barrier a round; there is no fallback from one
to the other.
"""

from __future__ import annotations

import torch

from .. import prng
from ..models.demers import RumorWorldPacked
from . import _native
from .bitset import WORD, biased_words, i32, lshr, mix32, wrap_i32
from .rumor_kernel import CELL, LANES, check_packed, check_table, mask_args

LAUNCHES = 0   # kernel launches (one a call); chip_smoke.py reads it
KEY_SEED = 0xB10C


def hbm_table(rnd0: int, n_rounds: int, n: int, fanout: int
              ) -> torch.Tensor:
    """[n_rounds, 2*fanout + 3] int32 on the CPU: q0 r0 q1 r1 ..., coin
    salt, churn salt, patient zero.  The salts mix the reference's round
    seed with the round index (streams 0 and 7777 + i, as the TPU kernel
    seeded its PRNG with ``(seeds[i], 7777 + ...)`` for churn)."""
    R = n // CELL
    key = prng.fold_in(prng.PRNGKey(KEY_SEED), rnd0)
    kq, kr, kp, ks = prng.split(key, 4)
    q = prng.randint(kq, (n_rounds, fanout), 0, R)
    r = prng.randint(kr, (n_rounds, fanout), 1, CELL)
    pz = prng.randint(kp, (n_rounds,), 0, n)
    seeds = prng.randint(ks, (n_rounds,), 0, 1 << 30)
    i = torch.arange(n_rounds, dtype=torch.int64)
    coin_salt = mix32(seeds ^ mix32(wrap_i32(i)))
    churn_salt = mix32(seeds ^ mix32(wrap_i32(i + 7777)))
    qr = torch.stack([q, r], dim=-1).reshape(n_rounds, 2 * fanout)
    return torch.cat([qr, coin_salt[:, None], churn_salt[:, None],
                      pz[:, None]], dim=1).contiguous()


def _row_roll(x: torch.Tensor, s: int) -> torch.Tensor:
    """Rotate each row's 4096 bits: out bit j = in bit (j - s) mod 4096."""
    q, r = divmod(s, WORD)
    xw = torch.roll(x, q, dims=1)
    if r == 0:
        return xw
    prev = torch.roll(xw, 1, dims=1)
    return (xw << r) | lshr(prev, WORD - r)


def rumor_run_hbm_plain(packed: RumorWorldPacked, table: torch.Tensor,
                        n: int, stop_k: int = 1, churn: float = 0.0,
                        all_alive: bool = False,
                        died: list[int] | None = None) -> RumorWorldPacked:
    """The plain PyTorch version: the same semantics on [R, 128] words
    with ``torch.roll`` (the counterpart of the reference test's
    ``numpy_reference``).  ``died``, when given, gains the index of each
    round that ended with no hot & alive node, so that the next round
    restarts the rumor (one host sync a round)."""
    R = n // CELL
    fanout = (table.shape[1] - 3) // 2
    dev = packed.infected.device
    inf = packed.infected.reshape(R, LANES)
    hot = packed.hot.reshape(R, LANES)
    al = (torch.full_like(inf, -1) if all_alive
          else packed.alive.reshape(R, LANES))
    prev_alive_hot = None
    for i, rec in enumerate(table.tolist()):
        hit = torch.zeros_like(inf)
        for j in range(fanout):
            q, r = rec[2 * j], rec[2 * j + 1]
            hit = hit | _row_roll(torch.roll(hot & al, q, dims=0), r)
        send = hot & al
        new_inf = inf | (hit & al)
        dup = _row_roll(torch.roll(inf, -rec[0], dims=0), CELL - rec[1]) & send
        new_hot = hot | (new_inf & ~inf)
        salts = 2 * fanout
        if stop_k <= 1:
            new_hot = new_hot & ~dup
        else:
            coin = biased_words(rec[salts], 1.0 / stop_k, R * LANES,
                                device=dev).reshape(R, LANES)
            new_hot = new_hot & ~(dup & coin)
        if churn > 0.0:
            reborn = biased_words(rec[salts + 1], churn, R * LANES,
                                  device=dev).reshape(R, LANES)
            new_inf = new_inf & ~reborn
            new_hot = new_hot & ~reborn
        if i > 0:
            pz = rec[salts + 2]
            bit = torch.where(prev_alive_hot == 0, i32(1 << (pz % WORD)), 0)
            wi = pz // WORD
            new_inf[wi // LANES, wi % LANES] |= bit
            new_hot[wi // LANES, wi % LANES] |= bit
        prev_alive_hot = ((new_hot & al) != 0).sum()
        if died is not None and int(prev_alive_hot) == 0:
            died.append(i)
        inf, hot = new_inf, new_hot
    return RumorWorldPacked(inf.reshape(-1), hot.reshape(-1), packed.alive,
                            packed.rnd + table.shape[0])


def rumor_run_hbm_cuda(packed: RumorWorldPacked, table: torch.Tensor,
                       n: int, stop_k: int = 1, churn: float = 0.0,
                       all_alive: bool = False) -> RumorWorldPacked:
    """One launch of ``csrc/rumor_hbm.cu`` over the whole table, on the
    current stream: 1024-thread blocks of 8 rows, as many as the card
    holds at once (132 at n = 2^24)."""
    global LAUNCHES
    fanout = check_table(table, 2)
    n_rounds = table.shape[0]
    check_packed(packed, n, n_rounds)
    dev = packed.infected.device
    if dev.type != "cuda":
        raise ValueError(f"the K4 kernel runs on a CUDA tensor, got {dev}")
    W = n // WORD
    table = table.to(dev).contiguous()
    inf = torch.empty((2, W), dtype=torch.int32, device=dev)
    hot = torch.empty((2, W), dtype=torch.int32, device=dev)
    inf[0].copy_(packed.infected)
    hot[0].copy_(packed.hot)
    counts = torch.zeros(n_rounds, dtype=torch.int32, device=dev)
    err = _native.lib().rumor_hbm_run(
        table.data_ptr(), n_rounds, fanout, n // CELL, int(all_alive),
        *mask_args(stop_k, churn), packed.alive.data_ptr(),
        inf.data_ptr(), hot.data_ptr(), counts.data_ptr(),
        _native.stream_handle(inf))
    _native.check(err, "rumor_hbm_run")
    LAUNCHES += 1
    slot = n_rounds % 2
    return RumorWorldPacked(inf[slot], hot[slot], packed.alive,
                            packed.rnd + n_rounds)


def barrier_probe_cuda(n_rounds: int, n: int, device="cuda") -> None:
    """K4's grid barrier alone: ``n_rounds`` arrive-and-wait rounds on the
    grid ``rumor_run_hbm_cuda`` takes for n nodes.  A timing probe for the
    share of a round that is the barrier; it computes nothing and counts
    no launch."""
    counts = torch.zeros(n_rounds, dtype=torch.int32, device=device)
    err = _native.lib().rumor_hbm_barrier_run(n_rounds, n, counts.data_ptr(),
                                              _native.stream_handle(counts))
    _native.check(err, "rumor_hbm_barrier_run")


def rumor_run_hbm(packed: RumorWorldPacked, n_rounds: int, n: int,
                  fanout: int = 2, stop_k: int = 1, churn: float = 0.0,
                  block_rows: int = 1024, all_alive: bool = False
                  ) -> RumorWorldPacked:
    """Run ``n_rounds`` of rumor mongering with state in device memory.

    ``n`` must be a multiple of ``min(block_rows, n/4096) * 4096``, the
    reference's contract; the CUDA kernel's own tile is one 128-word row
    whatever ``block_rows`` is.  Returns the same type on the same device:
    the kernel for a CUDA tensor, the plain version for a CPU one.
    """
    check_packed(packed, n, n_rounds)
    R = n // CELL
    B = min(block_rows, R)
    if R % B != 0:
        raise ValueError(f"n/{CELL} = {R} rows must divide into {B}-row "
                         "blocks")
    table = hbm_table(int(packed.rnd), n_rounds, n, fanout)
    run = rumor_run_hbm_cuda if packed.infected.is_cuda \
        else rumor_run_hbm_plain
    return run(packed, table, n, stop_k, churn, all_alive)
