"""K3's one-barrier schedule (``partisan_tpu_torch/csrc/rumor_fused.cu``)
modelled in PyTorch on the CPU and held against the packed scan
(``demers.rumor_run_packed``, K3's plain version) bit for bit.

The kernel takes one grid barrier a round.  Its barrier word for round i
counts the blocks in (low half) and the blocks that still hold a hot &
alive word (high half); when the high half is 0 the rumor died, and round
i + 1 ORs patient zero's bit into every load of that word: its own word
and every rolled read.  The last round's restart goes straight into the
output after the loop.  The model below follows that data flow word for
word (the two source words of every roll, the blocks of a grid-stride
layout), so a fault in the deferred reseed shows here, before the card.
"""

import numpy as np
import pytest
import torch

from partisan_tpu_torch.models import demers
from partisan_tpu_torch.ops import bitset, rumor_kernel
from partisan_tpu_torch.ops.bitset import WORD, lshr

ROUNDS = 200
HOT_BLOCK = 1 << 16
GRID = (3, 32)   # blocks, threads: several words a thread, a ragged tail


def rolled(x0, x1, s):
    """Word-wise roll_bits from the two source words, as the kernel's
    funnel shift computes it."""
    r = s % WORD
    return x0 if r == 0 else (x0 << r) | lshr(x1, WORD - r)


def mask_rows(salts, p, nw):
    """[rounds, nw] words of ``biased_words(salt, p, nw)`` for each salt,
    all rounds in one pass (the kernel computes a round's masks before
    that round starts: they read no state)."""
    iota = bitset.wrap_i32(torch.arange(nw, dtype=torch.int64) * 2654435761)
    salts = salts.to(torch.int32)[:, None]
    return bitset.bernoulli_expand(
        lambda d: bitset.mix32(iota ^ salts ^ bitset.i32(d * 0x9E3779B9)), p)


def one_barrier_run(w, table, n, stop_k, churn, grid=GRID):
    """The kernel's schedule; returns (world, rounds whose rumor died)."""
    nw = n // WORD
    fanout = table.shape[1] - 3
    blocks, threads = grid
    word = torch.arange(nw)
    block = (word % (blocks * threads)) // threads
    a = w.alive
    inf, hot = w.infected, w.hot
    reseed = None   # (word, bit) of the last round's restart
    died = []
    coins = (mask_rows(table[:, fanout], 1.0 / stop_k, nw) if stop_k > 1
             else torch.full((table.shape[0], nw), -1, dtype=torch.int32))
    reborns = (mask_rows(table[:, fanout + 1], churn, nw) if churn > 0.0
               else torch.zeros((table.shape[0], nw), dtype=torch.int32))

    def load(buf, idx):
        if reseed is None:
            return buf[idx]
        return buf[idx] | torch.where(idx == reseed[0], reseed[1], 0)

    def roll_read(buf, s, extra=None):
        src = (word - s // WORD) % nw
        prev = (src - 1) % nw
        x0, x1 = load(buf, src), load(buf, prev)
        if extra is not None:
            x0, x1 = x0 & extra[src], x1 & extra[prev]
        return rolled(x0, x1, s)

    for i, row in enumerate(table.tolist()):
        shifts, pz, coin, reborn = row[:fanout], row[-1], coins[i], reborns[i]
        f, h = load(inf, word), load(hot, word)
        hit = torch.zeros_like(f)
        for s in shifts:
            hit = hit | roll_read(hot, s, a)
        new_inf = f | (hit & a)
        dup = roll_read(inf, n - shifts[0]) & (h & a)
        new_hot = (h | (new_inf & ~f)) & ~(dup & coin) & ~reborn
        inf, hot = new_inf & ~reborn, new_hot
        # the arrive: 1 a block, plus HOT_BLOCK from each block with a sender
        hot_blocks = torch.zeros(blocks, dtype=torch.int64).index_add_(
            0, block, ((new_hot & a) != 0).long()) > 0
        count = blocks + HOT_BLOCK * int(hot_blocks.sum())
        assert count & (HOT_BLOCK - 1) == blocks
        reseed = None
        if count >> 16 == 0:
            died.append(i)
            reseed = (pz // WORD, torch.tensor(1 << pz % WORD).to(
                torch.int32))
    if reseed is not None:   # the epilogue
        inf, hot = inf.clone(), hot.clone()
        inf[reseed[0]] |= reseed[1]
        hot[reseed[0]] |= reseed[1]
    return (demers.RumorWorldPacked(inf, hot, w.alive,
                                    w.rnd + table.shape[0]), died)


def packed_world(n, seed, hot):
    """~20% infected, a tenth of the nodes dead; ``hot`` False starts with
    no hot node, so the first round restarts the rumor."""
    rng = np.random.default_rng(seed)
    inf = rng.random(n) < 0.2
    masks = (inf, inf & (rng.random(n) < (0.5 if hot else 0.0)),
             rng.random(n) >= 0.1)
    return demers.rumor_pack(demers.RumorWorld(
        *(torch.from_numpy(m) for m in masks),
        rnd=torch.tensor(seed, dtype=torch.int32)))


def assert_same(want, got):
    assert torch.equal(want.infected, got.infected)
    assert torch.equal(want.hot, got.hot)
    assert int(want.rnd) == int(got.rnd)


@pytest.mark.parametrize("fanout", [1, 2])
@pytest.mark.parametrize("churn", [0.0, 0.01, 0.3])
@pytest.mark.parametrize("stop_k", [1, 3])
@pytest.mark.parametrize("n", [4096, 8192])
def test_one_barrier_schedule_matches_the_packed_scan(n, stop_k, churn,
                                                      fanout):
    """At N=8192 the world starts with no hot node: round 0 restarts."""
    hot = n == 4096
    w = packed_world(n, n + stop_k + fanout, hot)
    table = rumor_kernel.rumor_table(int(w.rnd), ROUNDS, n, fanout)
    want = demers.rumor_run_packed(w, table, n, stop_k, churn)
    got, died = one_barrier_run(w, table, n, stop_k, churn)
    assert_same(want, got)
    assert hot or died[0] == 0


@pytest.mark.parametrize("n", [4096, 8192])
def test_a_world_that_dies_and_restarts_many_times(n):
    """Fanout 1 at churn 0.6: a restarted rumor rarely outlives a few
    rounds, so nearly every other round takes the deferred reseed."""
    w = packed_world(n, 11, True)
    table = rumor_kernel.rumor_table(int(w.rnd), ROUNDS, n, 1)
    got, died = one_barrier_run(w, table, n, 1, 0.6)
    plain_died = []
    assert_same(demers.rumor_run_packed(w, table, n, 1, 0.6, plain_died),
                got)
    assert len(died) >= ROUNDS // 4, len(died)
    assert died == plain_died


def test_restart_on_the_last_round_and_at_the_ring_ends():
    """Patient zero in word 0 and in the last word (the rolls' wrap), and
    calls that end on a round whose rumor died (the epilogue)."""
    n, stop_k, churn = 4096, 1, 0.6
    w = packed_world(n, 7, False)
    table = rumor_kernel.rumor_table(int(w.rnd), ROUNDS, n, 1)
    table[0::2, -1] = torch.arange(0, ROUNDS, 2) % WORD
    table[1::2, -1] = n - 1 - torch.arange(1, ROUNDS, 2) % WORD
    _, died = one_barrier_run(w, table, n, stop_k, churn)
    assert {0, 1} <= {d % 2 for d in died}
    for last in died[-3:]:
        cut = table[:last + 1]
        got, d = one_barrier_run(w, cut, n, stop_k, churn)
        assert d[-1] == last
        assert_same(demers.rumor_run_packed(w, cut, n, stop_k, churn), got)
