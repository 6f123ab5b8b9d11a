"""Dense-representation HyParView — the counterpart of
``partisan_tpu/models/hyparview_dense.py``, bit-exact with it.

One round of the membership protocol as whole-array operations over the
view tables (``active [N, A]``, ``passive [N, P]``, -1 padded):

  churn      restart-in-place: a Bernoulli fraction of live nodes loses
             its views and rejoins through one random contact;
  repair     an edge survives iff both ends are alive and list each
             other; pruned peers demote to the passive view;
  reseed     a live node with both views empty gets a random contact;
  promote    under-full nodes propose to a random passive candidate; the
             proposals route to their targets through ``reverse_select``
             (the K1 kernel on the card), targets accept up to 2, and an
             accepted proposer adds its target;
  shuffle    an ARWL-hop walk through active views; origin and endpoint
             exchange samples, the reverse direction routed by a second
             ``reverse_select``;
  merge      every demoted or sampled peer folds into the passive views in
             one random-priority merge.

Randomness follows the reference key for key: the round key is
``fold_in(PRNGKey(seed ^ 0xDE45E), rnd)``, per-site keys fold in a salt,
and per-(node, slot) bits are ``mix32(((id << 8) | slot) ^ salt)``.  The
scalar keys and salts of a round are derived from CPU keys and a host
copy of the round number, so a round never copies a key to the card or
waits on it; the runners read ``state.rnd`` once per run and count up.  The ``[N]``-sized draws (churn, contacts, reseed) run on
the state's device.

The reference's TPU worker-fault workarounds (``refuse_tpu_shape_bug``,
``LAUNCH_CAP``/``launch_cap_for``) have no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import prng, resolve_device
from ..config import Config
from ..ops import padded_set as ps
from ..ops.bitset import lshr, mix32, wrap_i32
from ..ops.shard_exchange import reverse_select, take_rows
from .dense_cadence import block_scan

PHASES = frozenset({"repair", "promotion", "shuffle", "merge"})
ROUND_SEED = 0xDE45E
INIT_SEED = 0xD5E11


class DenseHvState(NamedTuple):
    active: torch.Tensor     # [N, A] int32 padded peer set
    passive: torch.Tensor    # [N, P] int32 padded peer set
    alive: torch.Tensor      # [N] bool
    rnd: torch.Tensor        # 0-d int32
    # [N] int32 partition ids (0 = unpartitioned), honoured when the round
    # is built with faults=True
    partition: Optional[torch.Tensor] = None


def dense_init(cfg: Config, seeds_per_node: int = 2, device=None
               ) -> DenseHvState:
    """Bootstrap: empty active views; each passive view seeded with
    ``seeds_per_node`` random contacts, never the node itself.  ``device``
    None means the card (raises without one)."""
    device = resolve_device(device)
    n = cfg.n_nodes
    seeds = prng.randint(prng.PRNGKey(cfg.seed ^ INIT_SEED),
                         (n, seeds_per_node), 0, n, device=device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    seeds = torch.where(seeds == ids[:, None], (seeds + 1) % n, seeds)
    passive = torch.full((n, cfg.max_passive_size), -1, dtype=torch.int32,
                         device=device)
    passive[:, :seeds_per_node] = seeds
    return DenseHvState(
        active=torch.full((n, cfg.max_active_size), -1, dtype=torch.int32,
                          device=device),
        passive=passive,
        alive=torch.ones(n, dtype=torch.bool, device=device),
        rnd=torch.zeros((), dtype=torch.int32, device=device),
        partition=torch.zeros(n, dtype=torch.int32, device=device))


def state_from_numpy(s, device=None) -> DenseHvState:
    """A reference ``DenseHvState`` (or anything with its fields, as
    numpy-convertible arrays) as a port state on ``device``."""
    device = resolve_device(device)

    def conv(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    part = getattr(s, "partition", None)
    return DenseHvState(
        active=conv(s.active, np.int32), passive=conv(s.passive, np.int32),
        alive=conv(s.alive, np.bool_),
        rnd=torch.tensor(int(np.asarray(s.rnd)), dtype=torch.int32,
                         device=device),
        partition=None if part is None else conv(part, np.int32))


def state_to_numpy(s: DenseHvState) -> DenseHvState:
    """The inverse of ``state_from_numpy``: the same NamedTuple holding
    numpy arrays and an np.int32 round."""
    def conv(t):
        return None if t is None else t.cpu().numpy()
    return DenseHvState(conv(s.active), conv(s.passive), conv(s.alive),
                        np.int32(int(s.rnd)), conv(s.partition))


_gather_rows = take_rows   # views[idx], idx < 0 giving an all-empty row


def _set_col0(views: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``views.at[:, 0].set(col)`` without touching ``views``."""
    return torch.cat([col[:, None].to(views.dtype), views[:, 1:]], dim=1)


def _node_slot_ctr(n: int, w: int, device) -> torch.Tensor:
    """[n, w] int64 counters ``(node << 8) | slot`` (uint32 values)."""
    ids = torch.arange(n, dtype=torch.int64, device=device)
    slots = torch.arange(w, dtype=torch.int64, device=device)
    return (ids[:, None] << 8) | slots[None, :]


def bulk_passive_merge(active, passive, cands, ids, key, rows=None
                       ) -> torch.Tensor:
    """Fold [N, K] candidate peers into the [N, P] passive views in one
    step (add_to_passive_view: not me, not in either view, random evict
    when full): random priority over the deduplicated union, keep the P
    highest.  ``key`` is one key, best held on the CPU.

    The priorities hash ``(row << 8) | slot``.  ``rows`` ([N] int) gives
    each row's counter; None counts the rows 0..N-1.  The reference's
    sharded round calls the merge inside ``shard_map``, where it counts
    each shard's rows from 0: the sharded round here passes
    ``gids % n_loc``."""
    n = active.shape[0]
    cat = torch.cat([passive, cands], dim=1)                      # [N, W]
    ok = (cat >= 0) & (cat != ids[:, None])
    ok &= ~(cat[:, :, None] == active[:, None, :]).any(-1)
    big = 1 << 30
    sv = torch.sort(torch.where(ok, cat, big), dim=1).values
    first = torch.ones_like(ok)
    first[:, 1:] = sv[:, 1:] != sv[:, :-1]
    ok2 = (sv < big) & first
    w = sv.shape[1]
    assert w <= 256, "merge priority counters pack the slot in 8 bits"
    s32 = int(prng.bits(key))
    if rows is None:
        ctr = _node_slot_ctr(n, w, sv.device)
    else:
        slots = torch.arange(w, dtype=torch.int64, device=sv.device)
        ctr = (rows.long()[:, None] << 8) | slots[None, :]
    pri = lshr(mix32(wrap_i32(ctr ^ s32)), 8)
    # the reference sorts float32 -pri with invalid slots at 1.0; pri is a
    # 24-bit integer, so the integer key below orders exactly the same,
    # ties kept in input order by the stable sort
    order = torch.sort(torch.where(ok2, -pri, 1), dim=1,
                       stable=True).indices
    out = torch.gather(torch.where(ok2, sv, -1), 1, order)
    return out[:, :passive.shape[1]]


def make_dense_round(cfg: Config, churn: float = 0.0,
                     skip: frozenset = frozenset(),
                     faults: bool = False,
                     interpose=None,
                     phase_window: int = 1,
                     shuffle_window: Optional[int] = None,
                     resub_policy=None) -> Callable[..., DenseHvState]:
    """One dense round, ``step(state, rnd=None) -> state``: deterministic
    from (cfg.seed, state.rnd).  ``rnd`` is the host's copy of
    ``int(state.rnd)``; None reads it from the state (one sync).

    The parameters are the reference's: ``phase_window=k`` widens the
    promotion and shuffle due masks to [rnd, rnd+k) (the heavy rounds of
    the staggered cadence; ``shuffle_window`` overrides the shuffle's);
    ``skip`` omits phases ({"repair", "promotion", "shuffle", "merge"});
    ``faults=True`` honours ``state.partition`` and calls ``interpose(phase,
    dst, rnd) -> keep`` on each wire-analog exchange ("promote",
    "shuffle_fwd"); ``resub_policy(lonely, rnd) -> keep`` gates the
    isolation reseed.  Hooks get ``rnd`` as the state's 0-d tensor."""
    if not skip <= PHASES:
        raise ValueError(f"unknown phase(s) in skip: {sorted(skip - PHASES)}")
    N = cfg.n_nodes
    A = cfg.max_active_size
    P = cfg.max_passive_size
    if N > (1 << 24):
        raise ValueError("rbits packs (node, slot) in (24, 8) bits: "
                         f"n_nodes={N} > 2^24")
    base_key = prng.PRNGKey(cfg.seed ^ ROUND_SEED)      # on the CPU

    def step(state: DenseHvState, rnd: Optional[int] = None
             ) -> DenseHvState:
        if rnd is None:
            rnd = int(state.rnd)
        key = prng.fold_in(base_key, rnd)
        active, passive, alive = state.active, state.passive, state.alive
        dev = active.device
        ids = torch.arange(N, dtype=torch.int32, device=dev)

        def rbits(salt: int, w: int) -> torch.Tensor:
            """[N, w] int32-carried uint32 bits for (node, slot)."""
            s32 = int(prng.bits(prng.fold_in(key, salt)))
            return mix32(wrap_i32(_node_slot_ctr(N, w, dev) ^ s32))

        def rand_node(salt: int) -> torch.Tensor:
            """[N] random node ids, never the node itself."""
            x = prng.randint(prng.fold_in(key, salt), (N,), 0, N,
                             device=dev)
            return torch.where(x == ids, (x + 1) % N, x)

        def alive_at(idx):
            return alive[idx.clamp(0, N - 1).long()]

        def wire_ok(dst, phase):
            if not faults:
                return dst
            keep = dst >= 0
            if state.partition is not None:
                keep &= state.partition == state.partition[
                    dst.clamp(0, N - 1).long()]
            if interpose is not None:
                keep &= interpose(phase, dst, state.rnd)
            return torch.where(keep, dst, -1)

        def due_in_window(interval, window=None):
            w = phase_window if window is None else window
            x = (rnd + ids) % interval
            return ((interval - x) % interval) < w

        # ---- churn: restart in place, rejoin through a random contact
        if churn > 0.0:
            u = prng.uniform(prng.fold_in(key, 0), (N,), device=dev)
            reset = (u < torch.full((), churn, dtype=torch.float32,
                                    device=dev)) & alive
            active = torch.where(reset[:, None], -1, active)
            contact = rand_node(1)
            passive = torch.where(reset[:, None], -1, passive)
            passive = _set_col0(passive,
                                torch.where(reset, contact, passive[:, 0]))

        demote = []
        # ---- repair: liveness + symmetry prune, demote to passive
        if "repair" not in skip:
            active = torch.where(alive[:, None], active, -1)
            peer_rows = _gather_rows(active, active)              # [N, A, A]
            mutual = (peer_rows == ids[:, None, None]).any(-1)
            ok_edge = (active >= 0) & mutual
            if faults and state.partition is not None:
                ok_edge &= state.partition[:, None] == state.partition[
                    active.clamp(0, N - 1).long()]
            demote.append(torch.where((active >= 0) & ~ok_edge, active, -1))
            active = torch.where(ok_edge, active, -1)

        # ---- isolation re-subscribe
        lonely = alive & ((active >= 0).sum(1) == 0) \
            & ((passive >= 0).sum(1) == 0)
        if resub_policy is not None:
            lonely = lonely & resub_policy(lonely, state.rnd)
        passive = _set_col0(passive, torch.where(lonely, rand_node(40),
                                                 passive[:, 0]))

        # ---- promotion / join (neighbor_request)
        if "promotion" not in skip:
            sizes = (active >= 0).sum(1)
            due = due_in_window(cfg.random_promotion_interval) \
                | (sizes == 0)
            cand = ps.random_member_bits(passive, rbits(3, P))
            cand = torch.where(ps.contains(active, cand), -1, cand)
            propose = alive & due & (sizes < A) & (cand >= 0)
            target = torch.where(propose, cand, -1)
            # a proposal to a dead candidate is refused and the candidate
            # leaves the passive view
            t_dead = propose & ~alive_at(target)
            passive = torch.where(
                passive == torch.where(t_dead, target, -2)[:, None],
                -1, passive)
            chosen = reverse_select(
                wire_ok(torch.where(t_dead, -1, target), "promote")
                .contiguous(),
                int(prng.bits(prng.fold_in(key, 4))), N, 2)       # [N, 2]
            acc = []
            for j in range(2):
                p_j = chosen[:, j]
                high = ((_gather_rows(active, p_j[:, None])[:, 0] >= 0)
                        .sum(-1) == 0)                  # proposer isolated
                room = (active >= 0).sum(1) < A
                a_j = (p_j >= 0) & alive & (room | high)
                acc.append(a_j)
                active, evicted, _ = ps.insert_evict_bits(
                    active, torch.where(a_j, p_j, -1), rbits(5 + j, 1)[:, 0])
                demote.append(evicted[:, None])
            # proposer side: did my target accept me?
            tc = target.clamp(0, N - 1).long()
            accepted = propose & ~t_dead & (
                ((chosen[tc, 0] == ids) & acc[0][tc])
                | ((chosen[tc, 1] == ids) & acc[1][tc]))
            active, ev2, _ = ps.insert_evict_bits(
                active, torch.where(accepted, target, -1), rbits(9, 1)[:, 0])
            demote.append(ev2[:, None])

        # ---- shuffle (passive view maintenance)
        if "shuffle" not in skip:
            due_s = alive & due_in_window(cfg.shuffle_interval,
                                          shuffle_window)
            samp = torch.cat([
                ids[:, None],
                ps.random_k_bits(active, rbits(11, A), cfg.shuffle_k_active),
                ps.random_k_bits(passive, rbits(12, P),
                                 cfg.shuffle_k_passive),
            ], dim=1)                                             # [N, S]
            e = ids
            for h in range(cfg.arwl):
                step_to = ps.random_member_bits(
                    _gather_rows(active, e), rbits(13 + h, A),
                    exclude=torch.stack([ids, e], dim=1))
                e = torch.where(step_to >= 0, step_to, e)
            ep = wire_ok(torch.where(due_s & (e != ids) & alive_at(e), e, -1),
                         "shuffle_fwd")
            # forward merge: the origin folds the endpoint's sample
            demote.append(_gather_rows(samp, ep))
            # reverse merge: endpoints fold up to 2 origins' samples
            rchosen = reverse_select(
                ep.contiguous(), int(prng.bits(prng.fold_in(key, 31))), N, 2)
            for j in range(2):
                demote.append(_gather_rows(samp, rchosen[:, j]))

        # ---- one passive merge for every phase's candidates
        if "merge" not in skip and demote:
            passive = bulk_passive_merge(active, passive,
                                         torch.cat(demote, dim=1), ids,
                                         prng.fold_in(key, 50))

        return DenseHvState(active=active, passive=passive, alive=alive,
                            rnd=state.rnd + 1, partition=state.partition)

    return step


def run_dense(state: DenseHvState, n_rounds: int, cfg: Config,
              churn: float = 0.0) -> DenseHvState:
    """``n_rounds`` every-round rounds; reads ``state.rnd`` once."""
    step = make_dense_round(cfg, churn)
    rnd = int(state.rnd)
    for i in range(n_rounds):
        state = step(state, rnd + i)
    return state


def staggered_programs(cfg: Config, churn: float, k: int):
    """(heavy promotion+shuffle, heavy promotion, light) round programs of
    the staggered cadence: promotion every k rounds, shuffle every 2k,
    churn + isolation reseed every round."""
    # exactness: a window may contain at most ONE nominal due round per
    # node, else the batching silently under-runs the cadence
    if cfg.random_promotion_interval < k or cfg.shuffle_interval < 2 * k:
        raise ValueError(
            f"staggered cadence needs random_promotion_interval >= k and "
            f"shuffle_interval >= 2k (k={k}, got "
            f"{cfg.random_promotion_interval}/{cfg.shuffle_interval}); "
            f"use the every-round runner for hotter cadences")
    heavy_ps = make_dense_round(cfg, churn, phase_window=k,
                                shuffle_window=2 * k)
    heavy_p = make_dense_round(cfg, churn, phase_window=k,
                               skip=frozenset({"shuffle"}))
    light = make_dense_round(cfg, churn, skip=PHASES)
    return heavy_ps, heavy_p, light


def staggered_scan(bodies, carry, n_blocks: int, k: int):
    """Drive the block layout [heavy_ps, light x k-1, heavy_p, light x k-1]
    for ``n_blocks`` blocks; ``bodies`` are ``carry -> carry`` functions
    for the three programs of :func:`staggered_programs`."""
    hps_body, hp_body, light_body = bodies
    return block_scan([(hps_body, 1), (light_body, k - 1),
                       (hp_body, 1), (light_body, k - 1)],
                      carry, n_blocks)


def run_dense_staggered(state: DenseHvState, n_blocks: int, cfg: Config,
                        churn: float = 0.0, k: int = 5) -> DenseHvState:
    """The phase-staggered cadence on the reference's timers (shuffle
    every 2k rounds, promotion every k, churn every round): ``n_blocks *
    2k`` rounds; reads ``state.rnd`` once and counts up on the host."""
    def counted(program):
        return lambda c: (program(c[0], c[1]), c[1] + 1)

    bodies = tuple(counted(p) for p in staggered_programs(cfg, churn, k))
    state, _ = staggered_scan(bodies, (state, int(state.rnd)), n_blocks, k)
    return state


def run_dense_chunked(state: DenseHvState, n_rounds: int, cfg: Config,
                      churn: float = 0.0) -> DenseHvState:
    """The reference splits long runs into capped XLA scans to dodge a TPU
    worker fault; the port launches round by round and has no scan to
    cap, so this is :func:`run_dense`."""
    return run_dense(state, n_rounds, cfg, churn)


def run_dense_staggered_chunked(state: DenseHvState, n_blocks: int,
                                cfg: Config, churn: float = 0.0,
                                k: int = 5) -> DenseHvState:
    """:func:`run_dense_staggered`, for the same reason as
    :func:`run_dense_chunked`."""
    return run_dense_staggered(state, n_blocks, cfg, churn, k)


# ------------------------------------------------------------- health

def _hv_expand(active: torch.Tensor, alive: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """One BFS hop over the active overlay (live nodes only): the
    reference's scatter-max as a masked ``index_put_`` (dropped indices
    land in a spare slot)."""
    n = active.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=active.device)
    nb = _gather_rows(active, torch.where(r, ids, -1))    # rows of reached
    hit = torch.zeros(n + 1, dtype=torch.bool, device=active.device)
    idx = torch.where(nb >= 0, nb, n).reshape(-1).long()
    hit.index_put_((idx,), torch.ones_like(idx, dtype=torch.bool))
    return r | (hit[:n] & alive)


def _reach(state: DenseHvState) -> torch.Tensor:
    """BFS from the first live node to FIXPOINT, one hop per step.  The
    safety bound is the reference's ``bounded_bfs`` budget, max(4096, n)
    hops; exhausting it raises rather than report a truncated walk."""
    active, alive = state.active, state.alive
    n = active.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=active.device)
    r = ids == torch.argmax(alive.to(torch.int32))
    budget = max(4096, n)
    for _ in range(budget):
        r2 = _hv_expand(active, alive, r)
        if not bool((r2 != r).any()):
            return r
        r = r2
    raise RuntimeError(
        f"bounded_bfs: no fixpoint within {budget} hops at n={n} — "
        f"refusing to report connectivity from a truncated walk")


def _hv_stats(state: DenseHvState, reach: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    active, alive = state.active, state.alive
    n = active.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=active.device)
    mutual = (_gather_rows(active, active) == ids[:, None, None]).any(-1)
    occ = active >= 0
    sizes = occ.sum(1)
    live = alive.sum()
    denom = live.clamp(min=1).float()
    reached = (reach & alive).sum()
    return {
        "connected": reached == live,
        "reached": reached,
        "live": live,
        "symmetry": (mutual & occ).sum().float()
        / occ.sum().clamp(min=1).float(),
        "mean_active": torch.where(alive, sizes, 0).sum().float() / denom,
        "isolated": (alive & (sizes == 0)).sum(),
        "mean_passive": torch.where(alive, (state.passive >= 0).sum(1), 0)
        .sum().float() / denom,
    }


def connectivity(state: DenseHvState) -> Dict[str, torch.Tensor]:
    """Health: BFS reachability over the active overlay from the first
    live node, symmetry rate, view-size stats (the reference's
    hyparview_membership_check as array reductions)."""
    return _hv_stats(state, _reach(state))
