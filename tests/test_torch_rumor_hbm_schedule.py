"""K4's persistent schedule (``partisan_tpu_torch/csrc/rumor_hbm.cu``)
modelled in PyTorch on the CPU and held against ``rumor_run_hbm_plain``
(K4's plain version) bit for bit.

The kernel runs every round of a call in one launch.  Its blocks take
whole 128-word rows, several at a time, striding over the rows; a thread
keeps the same words every round.  One grid barrier a round: the barrier
word of round i counts the blocks in (low half) and the blocks that still
hold a hot & alive word (high half).  Between arrive and wait a thread
computes the next round's coin and churn words of its words (a warp leaves
the Bernoulli walk once none of its 32 words can change); after the wait,
a high half of 0 makes the owner of patient zero's word OR its bit into
that word of round i + 1's output.  The model below follows that data
flow word for word (the two source words of every rotated read, the
blocks' rows), so a fault in the deferred restart or the walk's exit
shows here, before the card.
"""

import numpy as np
import pytest
import torch

from partisan_tpu_torch.models.demers import RumorWorldPacked
from partisan_tpu_torch.ops import bitset, rumor_kernel_hbm
from partisan_tpu_torch.ops.bitset import WORD, lshr

N = 1 << 16      # 16 rows of 128 words
ROUNDS = 200
LANES = 128
CELL = LANES * WORD
HOT_BLOCK = 1 << 16
GRID = (3, 2)    # blocks, rows a block at a time: three rows a thread, ragged
DYING = 0.6      # churn at fanout 1 that kills the rumor every few rounds


def rolled(x0, x1, r):
    """Word-wise roll from the two source words, r in [0, 32)."""
    return x0 if r == 0 else (x0 << r) | lshr(x1, WORD - r)


def warp_walk(salts, p, nw):
    """[rounds, nw] words of ``biased_words(salt, p, nw)`` for each round's
    salt, as the kernel walks them: level by level, each warp of 32 words
    stopping once no bit of its words still ties p's prefix; returns
    (words, levels each warp walked)."""
    depth, ones = bitset.expansion(p)
    iota = bitset.wrap_i32(torch.arange(nw, dtype=torch.int64) * 2654435761)
    salts = torch.tensor(salts, dtype=torch.int64)
    draw0 = iota ^ bitset.wrap_i32(salts)[:, None]
    eq = torch.full(draw0.shape, -1, dtype=torch.int32)
    out = torch.zeros_like(eq)
    live = torch.ones(len(salts), nw // WORD, dtype=torch.bool)
    levels = torch.zeros(live.shape, dtype=torch.int64)
    for d in range(1, depth + 1):
        on = live.repeat_interleave(WORD, dim=1)
        u = bitset.mix32(draw0 ^ bitset.i32(d * 0x9E3779B9))
        if ones >> (d - 1) & 1:
            out = torch.where(on, out | (eq & ~u), out)
            eq = torch.where(on, eq & u, eq)
        else:
            eq = torch.where(on, eq & ~u, eq)
        levels += live
        live = live & (eq != 0).reshape(len(salts), -1, WORD).any(-1)
    return out, levels


def persistent_run(w, table, n, stop_k, churn, all_alive, grid=GRID):
    """The kernel's schedule; returns (world, rounds that ended with no hot
    & alive word, mean levels a warp walked)."""
    R, nw = n // CELL, n // WORD
    fanout = (table.shape[1] - 3) // 2
    blocks, rows_at_a_time = grid
    word = torch.arange(nw)
    row, lane = word // LANES, word % LANES
    block = (row // rows_at_a_time) % blocks
    al = torch.full((nw,), -1, dtype=torch.int32) if all_alive else w.alive
    rows = table.tolist()
    # the coin and churn words of every round: they read no state, and the
    # kernel takes round i + 1's between round i's arrive and wait
    coins = torch.full((len(rows), nw), -1, dtype=torch.int32)
    reborns = torch.zeros((len(rows), nw), dtype=torch.int32)
    walked = []
    if stop_k > 1:
        coins, lv = warp_walk(table[:, 2 * fanout].tolist(), 1.0 / stop_k, nw)
        walked.append(lv)
    if churn > 0.0:
        reborns, lv = warp_walk(table[:, 2 * fanout + 1].tolist(), churn, nw)
        walked.append(lv)

    def rotated_read(buf, prow, r, extra=None):
        """Word `lane` of row `prow` of buf rotated by r bits."""
        src = (lane - r // WORD) % LANES
        prev = (src - 1) % LANES
        x0, x1 = buf[prow * LANES + src], buf[prow * LANES + prev]
        if extra is not None:
            x0 = x0 & extra[prow * LANES + src]
            x1 = x1 & extra[prow * LANES + prev]
        return rolled(x0, x1, r % WORD)

    inf, hot = w.infected, w.hot
    coin, reborn = coins[0], reborns[0]
    restart, died = False, []
    for i, rec in enumerate(rows):
        f, h = inf, hot
        hit = torch.zeros_like(f)
        for j in range(fanout):
            q, r = rec[2 * j], rec[2 * j + 1]
            hit = hit | rotated_read(hot, (row - q) % R, r,
                                     None if all_alive else w.alive)
        dup = rotated_read(inf, (row + rec[0]) % R, CELL - rec[1])
        new_inf = f | (hit & al)
        new_hot = (h | (new_inf & ~f)) & ~(dup & h & al & coin) & ~reborn
        new_inf = new_inf & ~reborn
        if restart:   # the owner of patient zero's word
            pz = rec[2 * fanout + 2]
            bit = torch.where(word == pz // WORD, bitset.i32(1 << pz % WORD),
                              0).to(torch.int32)
            new_inf, new_hot = new_inf | bit, new_hot | bit
        inf, hot = new_inf, new_hot
        # the arrive: 1 a block, plus HOT_BLOCK from each block with a sender
        hot_blocks = torch.zeros(blocks, dtype=torch.int64).index_add_(
            0, block, ((new_hot & al) != 0).long()) > 0
        count = blocks + HOT_BLOCK * int(hot_blocks.sum())
        if i + 1 == len(rows):
            break
        coin, reborn = coins[i + 1], reborns[i + 1]   # before the wait
        assert count & (HOT_BLOCK - 1) == blocks   # the wait
        restart = count >> 16 == 0
        if restart:
            died.append(i)
    if count >> 16 == 0:
        died.append(len(rows) - 1)
    levels = float(torch.cat(walked).float().mean()) if walked else 0.0
    return (RumorWorldPacked(inf, hot, w.alive, w.rnd + table.shape[0]),
            died, levels)


def packed_world(n, seed, hot=True):
    """~20% infected, half of them hot (none when ``hot`` is False, so the
    first round ends with no sender), a tenth of the nodes dead."""
    rng = np.random.default_rng(seed)
    inf = rng.random(n) < 0.2
    masks = (inf, inf & (rng.random(n) < (0.5 if hot else 0.0)),
             rng.random(n) >= 0.1)
    words = [bitset.from_mask(torch.from_numpy(m)) for m in masks]
    return RumorWorldPacked(*words, torch.tensor(seed, dtype=torch.int32))


def check(w, fanout, stop_k, churn, all_alive):
    table = rumor_kernel_hbm.hbm_table(int(w.rnd), ROUNDS, N, fanout)
    plain_died = []
    want = rumor_kernel_hbm.rumor_run_hbm_plain(w, table, N, stop_k, churn,
                                                all_alive, plain_died)
    got, died, levels = persistent_run(w, table, N, stop_k, churn, all_alive)
    assert torch.equal(want.infected, got.infected)
    assert torch.equal(want.hot, got.hot)
    assert int(want.rnd) == int(got.rnd)
    assert died == plain_died
    return died, levels


@pytest.mark.parametrize("churn", [0.0, 0.01])
@pytest.mark.parametrize("stop_k", [1, 3])
@pytest.mark.parametrize("fanout", [1, 2, 3])
def test_persistent_schedule_matches_the_plain_version(fanout, stop_k,
                                                       churn):
    check(packed_world(N, 10 * fanout + stop_k), fanout, stop_k, churn,
          False)


def test_the_big_n_path_shape_all_alive():
    """fanout 2, stop_k 1, churn 0.01 with every node alive (the big-N
    path's call); the warps walk fewer levels than the expansion's 15."""
    _, levels = check(packed_world(N, 3), 2, 1, 0.01, True)
    assert 8.0 < levels < 15.0, levels


def test_no_sender_at_the_start_restarts_on_round_one():
    died, _ = check(packed_world(N, 5, hot=False), 2, 1, 0.01, False)
    assert died[0] == 0


def test_a_world_that_dies_and_restarts_many_times():
    """Fanout 1 at churn 0.6: a restarted rumor rarely outlives a few
    rounds, so many rounds take the deferred restart."""
    died, _ = check(packed_world(N, 11), 1, 1, DYING, False)
    assert len(died) >= ROUNDS // 5, len(died)
