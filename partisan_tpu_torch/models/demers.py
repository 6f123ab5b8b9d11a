"""Demers rumor mongering — section 3 of ``partisan_tpu/models/demers.py``
(the fast path of BASELINE #5, ``protocols/demers_rumor_mongering.erl`` at
10^6 nodes with 1% churn per round).

Per round every hot & alive node pushes to ``fanout`` partners; an alive
node that is hit becomes infected and hot; a sender whose first push lands
on an already-infected peer loses interest with probability 1/stop_k; a
``churn`` fraction of rows is replaced by fresh susceptible nodes; and
when no hot sender is left a new rumor starts at a random patient zero.

Randomness comes from the ported threefry (``prng``), keyed exactly as the
reference keys it, so every variant here is bit-exact with its reference
counterpart.  The per-round scalars are drawn for the whole run in one
vectorised pass (``rumor_draws``) instead of inside each round.

Variants of ``rumor_run``: ``"shift"`` and ``"uniform"`` on [N] bool
masks, ``"packed"`` on int32 words, and ``"fused"`` — the reference's
``"pallas"`` — which runs the whole call in the K3 CUDA kernel
(``ops/rumor_kernel.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import prng, resolve_device
from ..ops import bitset
from ..ops.bitset import WORD, biased_words, less_u32, mix32, roll_bits

VARIANTS = ("shift", "uniform", "packed", "fused")


class RumorWorld(NamedTuple):
    infected: torch.Tensor   # [N] bool — has the rumor (infected once)
    hot: torch.Tensor        # [N] bool — still actively spreading
    alive: torch.Tensor      # [N] bool — churn: dead rows lose state
    rnd: torch.Tensor        # 0-d int32


class RumorWorldPacked(NamedTuple):
    infected: torch.Tensor   # [N/32] int32 words (uint32 bits)
    hot: torch.Tensor        # [N/32] int32
    alive: torch.Tensor      # [N/32] int32
    rnd: torch.Tensor        # 0-d int32


def rumor_init(n: int, patient_zero: int = 0, device=None) -> RumorWorld:
    device = resolve_device(device)
    infected = torch.zeros(n, dtype=torch.bool, device=device)
    infected[patient_zero] = True
    return RumorWorld(infected=infected, hot=infected.clone(),
                      alive=torch.ones(n, dtype=torch.bool, device=device),
                      rnd=torch.zeros((), dtype=torch.int32, device=device))


def rumor_pack(w: RumorWorld) -> RumorWorldPacked:
    return RumorWorldPacked(
        infected=bitset.from_mask(w.infected), hot=bitset.from_mask(w.hot),
        alive=bitset.from_mask(w.alive), rnd=w.rnd)


def rumor_unpack(w: RumorWorldPacked, n: int) -> RumorWorld:
    return RumorWorld(
        infected=bitset.to_mask(w.infected, n),
        hot=bitset.to_mask(w.hot, n),
        alive=bitset.to_mask(w.alive, n), rnd=w.rnd)


def world_from_numpy(w, device=None):
    """A reference ``RumorWorld`` or ``RumorWorldPacked`` (or anything with
    the same four fields, as numpy-convertible arrays) as a port world.
    uint32 words become the int32 words with the same bits."""
    device = resolve_device(device)
    fields = [np.asarray(getattr(w, f))
              for f in ("infected", "hot", "alive")]
    rnd = torch.tensor(int(np.asarray(w.rnd)), dtype=torch.int32,
                       device=device)
    if fields[0].dtype == np.bool_:
        t = [torch.from_numpy(f.copy()).to(device) for f in fields]
        return RumorWorld(*t, rnd=rnd)
    t = [torch.from_numpy(f.astype(np.uint32).view(np.int32)).to(device)
         for f in fields]
    return RumorWorldPacked(*t, rnd=rnd)


def world_to_numpy(w):
    """The inverse of ``world_from_numpy``: the same NamedTuple holding
    numpy arrays (bool masks, or uint32 words) and an np.int32 round."""
    conv = ((lambda t: t.cpu().numpy()) if isinstance(w, RumorWorld)
            else (lambda t: t.cpu().numpy().view(np.uint32)))
    return type(w)(conv(w.infected), conv(w.hot), conv(w.alive),
                   np.int32(int(w.rnd)))


class RumorDraws(NamedTuple):
    """One run's per-round scalars, row i for round ``rnd0 + i``."""
    shifts: torch.Tensor      # [rounds, fanout] in [1, n)
    coin_salt: torch.Tensor   # [rounds] uint32 values (int64)
    churn_salt: torch.Tensor  # [rounds] uint32 values (int64)
    pz: torch.Tensor          # [rounds] in [0, n)
    k_tgt: torch.Tensor       # [rounds, 2] keys (the "uniform" target draws)


def rumor_draws(rnd0: int, n_rounds: int, n: int, fanout: int,
                seed: int = 1) -> RumorDraws:
    """The reference's per-round keys, all rounds at once:
    ``k = fold_in(PRNGKey(seed), rnd)``, ``k_tgt, k_coin, k_churn =
    split(k, 3)``, shifts ``randint(k_tgt, (fanout,), 1, n)``, salts
    ``bits(k_coin)`` / ``bits(k_churn)`` and patient zero
    ``randint(fold_in(k, 7), (), 0, n)``."""
    rounds = torch.arange(rnd0, rnd0 + n_rounds, dtype=torch.int64)
    k = prng.fold_in(prng.PRNGKey(seed), rounds)
    ks = prng.split(k, 3)
    return RumorDraws(
        shifts=prng.randint(ks[:, 0], (fanout,), 1, n),
        coin_salt=prng.bits(ks[:, 1]),
        churn_salt=prng.bits(ks[:, 2]),
        pz=prng.randint(prng.fold_in(k, 7), (), 0, n),
        k_tgt=ks[:, 0])


def rumor_table(rnd0: int, n_rounds: int, n: int, fanout: int
                ) -> torch.Tensor:
    """[n_rounds, fanout + 3] int32 on the CPU, the packed scan's input:
    the shifts, coin salt, churn salt and patient zero of each round
    (salts as int32 bits)."""
    dr = rumor_draws(rnd0, n_rounds, n, fanout)
    return bitset.wrap_i32(torch.cat(
        [dr.shifts.long(), dr.coin_salt[:, None], dr.churn_salt[:, None],
         dr.pz.long()[:, None]], dim=1))


def _threshold(p: float) -> int:
    return min(max(1, round(p * 4294967296)), 4294967295)


def _rumor_steps(w: RumorWorld, n_rounds: int, n: int, fanout: int,
                 stop_k: int, churn: float, variant: str) -> RumorWorld:
    """``make_rumor_step`` (``"shift"`` / ``"uniform"``) for n_rounds."""
    dev = w.infected.device
    dr = rumor_draws(int(w.rnd), n_rounds, n, fanout)
    shifts, coin_salt, churn_salt, pz = (t.tolist() for t in dr[:4])
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    node = torch.arange(n, dtype=torch.int64, device=dev)
    inf, hot, alive = w.infected, w.hot, w.alive

    def bernoulli_hash(salt, p):
        return less_u32(mix32(iota ^ bitset.i32(salt)), _threshold(p))

    for i in range(n_rounds):
        send = hot & alive
        if variant == "shift":
            hit = torch.zeros_like(send)
            for s in shifts[i]:
                hit = hit | torch.roll(send, s)
            new_inf = inf | (hit & alive)
            dup = torch.roll(inf, -shifts[i][0]) & send
        else:
            # uniform over all peers except self
            offs = prng.randint(dr.k_tgt[i].to(dev), (n, fanout), 1, n)
            targets = (node[:, None] + offs) % n
            tflat = targets.reshape(-1)
            hit = send.repeat_interleave(fanout) & alive[tflat]
            new_inf = inf.to(torch.uint8).scatter_reduce(
                0, tflat, hit.to(torch.uint8), "amax").bool()
            dup = inf[targets[:, 0]] & send
        new_hot = hot | (new_inf & ~inf)
        if stop_k <= 1:
            new_hot = new_hot & ~dup
        else:
            new_hot = new_hot & ~(dup & bernoulli_hash(coin_salt[i],
                                                      1.0 / stop_k))
        if churn > 0.0:
            reborn = bernoulli_hash(churn_salt[i], churn)
            new_inf = new_inf & ~reborn
            new_hot = new_hot & ~reborn
        dead = ~(new_hot & alive).any()
        new_inf[pz[i]] |= dead
        new_hot[pz[i]] |= dead
        inf, hot = new_inf, new_hot
    return RumorWorld(inf, hot, alive, w.rnd + n_rounds)


def packed_round(inf, hot, alive, n: int, shifts, coin_salt: int,
                 churn_salt: int, pz: int, stop_k: int, churn: float):
    """One round of ``make_rumor_step_packed`` on int32 words, given the
    round's drawn scalars; returns (infected', hot', dead): ``dead`` a
    bool tensor, true when no hot & alive node was left, so patient zero
    restarted the rumor."""
    W = n // WORD
    send = hot & alive
    hit = torch.zeros_like(send)
    for s in shifts:
        hit = hit | roll_bits(send, s, n)
    new_inf = inf | (hit & alive)
    dup = roll_bits(inf, n - shifts[0], n) & send
    new_hot = hot | (new_inf & ~inf)
    dev = inf.device
    if stop_k <= 1:
        new_hot = new_hot & ~dup
    else:
        coin = biased_words(coin_salt, 1.0 / stop_k, W, device=dev)
        new_hot = new_hot & ~(dup & coin)
    if churn > 0.0:
        reborn = biased_words(churn_salt, churn, W, device=dev)
        new_inf = new_inf & ~reborn
        new_hot = new_hot & ~reborn
    # a tensor select, not a host branch: no sync per round on the card
    dead = ~((new_hot & alive) != 0).any()
    bit = torch.where(dead, bitset.i32(1 << (pz % WORD)), 0)
    new_inf[pz // WORD] |= bit
    new_hot[pz // WORD] |= bit
    return new_inf, new_hot, dead


def rumor_run_packed(w: RumorWorldPacked, table: torch.Tensor, n: int,
                     stop_k: int = 1, churn: float = 0.0,
                     died: list[int] | None = None) -> RumorWorldPacked:
    """The packed round (``make_rumor_step_packed``) for each row of a
    drawn ``rumor_table``.  ``died``, when given, gains the index of each
    round in which the rumor died and restarted (one host sync a round)."""
    assert n % WORD == 0, "packed rumor wants n % 32 == 0"
    fanout = table.shape[1] - 3
    inf, hot = w.infected, w.hot
    for i, row in enumerate(table.tolist()):
        inf, hot, dead = packed_round(inf, hot, w.alive, n, row[:fanout],
                                      row[fanout], row[fanout + 1],
                                      row[fanout + 2], stop_k, churn)
        if died is not None and bool(dead):
            died.append(i)
    return RumorWorldPacked(inf, hot, w.alive, w.rnd + table.shape[0])


def rumor_run(w: RumorWorld, n_rounds: int, n: int, fanout: int = 2,
              stop_k: int = 1, churn: float = 0.0,
              variant: str = "shift") -> RumorWorld:
    """n_rounds of rumor mongering on the world's device.  ``"fused"``
    runs them in one launch of the K3 kernel on the card (its plain
    version on the CPU; n must be a multiple of 4096)."""
    if variant not in VARIANTS:
        raise ValueError(
            f"unknown rumor variant {variant!r}; expected one of {VARIANTS} "
            "(the reference's 'pallas' kernel is 'fused' here)")
    if variant == "fused":
        from ..ops.rumor_kernel import rumor_run_fused
        out = rumor_run_fused(rumor_pack(w), n_rounds, n, fanout, stop_k,
                              churn)
        return rumor_unpack(out, n)
    if variant == "packed":
        table = rumor_table(int(w.rnd), n_rounds, n, fanout)
        out = rumor_run_packed(rumor_pack(w), table, n, stop_k, churn)
        return rumor_unpack(out, n)
    return _rumor_steps(w, n_rounds, n, fanout, stop_k, churn, variant)
