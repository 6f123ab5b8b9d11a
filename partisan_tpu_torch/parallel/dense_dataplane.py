"""The sharded dense dataplane — the counterpart of
``partisan_tpu/parallel/dense_dataplane.py``, bit-exact with it.

The reference re-expresses the dense HyParView, Plumtree and SCAMP rounds
for ``shard_map``: every cross-row read of the unsharded round becomes
MAIL, a fixed-layout int32 outbox carried in the state, moved by ONE
bucketed all-to-all at the top of the next round
(``ops/shard_exchange.bucket_exchange``, through K2) and routed to its
destination rows by ONE shard-local sort over the (kind, local node) key
space (``ops/shard_exchange.route_select``, through K1), with one metrics
all-reduce a round.  Mail rows are ``[valid, dst, src, kind, part,
p0..p9]`` (MAIL_COLS = 15); the receive side drops rows for a dead or
cross-partition destination.  The protocol notes of each model are the
reference module's docstring.

Here the D shards are virtual (``parallel/mesh.py``): the state keeps the
reference's global ``[N, ...]`` layout on one device, shard k owning rows
``[k*n_loc, (k+1)*n_loc)``, and the round body runs once over all N rows,
because everything in it is row-local but three pieces that see the
shards:

  exchange  ``bucket_exchange`` over the ``[D, n_loc*slots, C]`` view of
            the outbox: one K2 call packs every shard, one
            ``mesh.all_to_all`` moves the buckets;
  route     ``route_select``, one K1 call a shard over its received rows
            (the tie-break hashes the row index in the shard's mailbox, so
            the mailbox order is the reference's: sender-shard-major, each
            bucket in stable outbox order);
  merge     ``bulk_passive_merge`` with each row's index in its shard as
            the priority counter, as inside ``shard_map`` (a quirk of the
            reference: a node's merge depends on D; ROADMAP C).

The metrics are per-shard sums reduced by one ``mesh.all_reduce``; the
exchange's and the route's overflow accumulate per shard in ``dropped``.

Randomness follows the reference key for key: per-round keys fold the
round into ``PRNGKey(seed ^ tag)`` on the host, scalars are Python ints,
and per-(node, slot) bits are ``mix32(((gid << 8) | slot) ^ salt)`` from
GLOBAL node ids.  A step is ``step(state, rnd=None) -> (state, metrics)``:
``rnd`` is the host's copy of ``int(state.rnd)`` (None reads it, one
sync); the runners read it once and count up.

Not ported yet: the flight recorder (``flight=``), the chaos node plane
(``chaos=``) and the adaptive control plane (``control=``), each of which
raises a named ValueError; the scamp and plumtree readbacks
(``to_dense_scamp``, ``to_pt_dense``) wait for the unsharded models.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import prng, resolve_device
from ..config import Config
from ..models import dense_cadence
from ..models.hyparview_dense import (DenseHvState, _set_col0,
                                      bulk_passive_merge, dense_init)
from ..models.scamp_dense import walker_caps
from ..ops import padded_set as ps
from ..ops.bitset import i32, less_u32, lshr, mix32, wrap_i32
from ..ops.shard_exchange import (bucket_exchange, default_bucket_cap,
                                  route_select, take_rows, take_vals)

MASK = 0xFFFFFFFF

# ---- mail layout: [valid, dst, src, kind, part, p0..p9] ----------------
N_PAYLOAD = 10
MAIL_COLS = 5 + N_PAYLOAD

# hyparview/plumtree mail kinds
K_KEEPALIVE = 0   # p0 = sender's plumtree seq (0 in plain hyparview)
K_PROPOSE = 1     # p0 = proposer-isolated priority bit
K_ACCEPT = 2      # "your proposal to me succeeded"
K_DISCONNECT = 3  # explicit eviction notice
K_SHUF = 4        # p0 = origin, p1 = ttl, p2..p9 = 8-id sample
K_SHUF_REPLY = 5  # p2..p9 = 8-id sample back to the origin
HV_KINDS = 6

# scamp mail kinds
S_WALK = 0        # p0 = subject, p1 = age
S_NOTIFY = 1      # src = holder that admitted dst's subscription
S_JOIN = 2        # src = (re)subscriber, dst = contact
SCAMP_KINDS = 3

HV_SEED = 0xD5DA7A
SCAMP_SEED = 0x5CADA7
HV_SKIP = frozenset({"promotion", "shuffle", "repair", "merge"})


def hv_mail_slots(cfg: Config) -> int:
    """Static outbox rows per node per round (hyparview/plumtree):
    A keepalives + 1 propose + 2 accept-replies + 2 evict-disconnects
    from proposal handling + 2 from accept handling + 1 shuffle init +
    2 shuffle forwards + 2 shuffle replies."""
    return cfg.max_active_size + 12


def scamp_mail_slots(cfg: Config) -> int:
    """1 join + 2*C spawn fan + 6 walk forwards + 6 keep-notifies."""
    _, c = walker_caps(cfg)
    return 1 + 2 * c + 12


# ---- state ------------------------------------------------------------

class ShardedDenseHv(NamedTuple):
    """Sharded hyparview state in the global layout: the unsharded planes,
    the keepalive stamp plane and the mail outbox; ``dropped`` is one
    cumulative overflow count a shard."""
    active: torch.Tensor     # [N, A] int32
    passive: torch.Tensor    # [N, P] int32
    astamp: torch.Tensor     # [N, A] round of last keepalive per slot
    alive: torch.Tensor      # [N] bool
    partition: torch.Tensor  # [N] int32 (0 = unpartitioned)
    mail: torch.Tensor       # [N * hv_mail_slots, MAIL_COLS] outbox
    dropped: torch.Tensor    # [n_shards] int32, cumulative
    rnd: torch.Tensor        # 0-d int32


class ShardedDensePt(NamedTuple):
    """Plumtree fused over the sharded hyparview round."""
    hv: ShardedDenseHv
    seq: torch.Tensor        # [N] highest delivered broadcast seq
    parent: torch.Tensor     # [N] eager parent (-1 = none / root)
    pstale: torch.Tensor     # [N] rounds behind without parent delivery


class ShardedDenseScamp(NamedTuple):
    """Sharded SCAMP state: walkers live in the mail; no stale-sweep
    planes (the reference's named limitation)."""
    partial: torch.Tensor          # [N, P]
    in_view: torch.Tensor          # [N, P]
    alive: torch.Tensor            # [N] bool
    partition: torch.Tensor        # [N] int32
    last_join: torch.Tensor        # [N] round of last (re)subscribe
    insert_dropped: torch.Tensor   # [N] keeps refused by a full view
    walk_expired: torch.Tensor     # [N] walks dead of old age
    walk_truncated: torch.Tensor   # [N] join-fan copies lost to the cap
    in_view_dropped: torch.Tensor  # [N] notify inserts lost to a full view
    mail: torch.Tensor             # [N * scamp_mail_slots, MAIL_COLS]
    dropped: torch.Tensor          # [n_shards] int32, cumulative
    rnd: torch.Tensor              # 0-d int32


# ---- init / readback / carrying state across -------------------------

def _i32(shape, fill, device) -> torch.Tensor:
    return torch.full(shape, fill, dtype=torch.int32, device=device)


def _check_shards(n: int, n_shards: int) -> int:
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"n_nodes={n} does not split into {n_shards} "
                         f"shards")
    return n // n_shards


def sharded_dense_init(cfg: Config, n_shards: int, seeds_per_node: int = 2,
                       device=None) -> ShardedDenseHv:
    """The unsharded bootstrap (dense_init) + empty mail/stamp planes.
    ``device`` None means the card."""
    n = cfg.n_nodes
    _check_shards(n, n_shards)
    base = dense_init(cfg, seeds_per_node, device)
    dev = base.active.device
    return ShardedDenseHv(
        active=base.active, passive=base.passive,
        astamp=_i32((n, cfg.max_active_size), 0, dev),
        alive=base.alive, partition=_i32((n,), 0, dev),
        mail=_i32((n * hv_mail_slots(cfg), MAIL_COLS), 0, dev),
        dropped=_i32((n_shards,), 0, dev), rnd=_i32((), 0, dev))


def sharded_pt_init(cfg: Config, n_shards: int, device=None
                    ) -> ShardedDensePt:
    hv = sharded_dense_init(cfg, n_shards, device=device)
    n, dev = cfg.n_nodes, hv.active.device
    return ShardedDensePt(hv=hv, seq=_i32((n,), 0, dev),
                          parent=_i32((n,), -1, dev),
                          pstale=_i32((n,), 0, dev))


def sharded_scamp_init(cfg: Config, n_shards: int, device=None
                       ) -> ShardedDenseScamp:
    """Every node starts unsubscribed with ``last_join`` backdated, so
    round 0 re-subscribes the whole population through the JOIN mail."""
    n = cfg.n_nodes
    _check_shards(n, n_shards)
    dev = resolve_device(device)
    p, _ = walker_caps(cfg)
    z = functools.partial(_i32, (n,), 0, dev)
    return ShardedDenseScamp(
        partial=_i32((n, p), -1, dev), in_view=_i32((n, p), -1, dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        partition=z(), last_join=_i32((n,), -(1 << 20), dev),
        insert_dropped=z(), walk_expired=z(), walk_truncated=z(),
        in_view_dropped=z(),
        mail=_i32((n * scamp_mail_slots(cfg), MAIL_COLS), 0, dev),
        dropped=_i32((n_shards,), 0, dev), rnd=_i32((), 0, dev))


def to_dense(st: ShardedDenseHv) -> DenseHvState:
    """The unsharded state type, so ``hyparview_dense.connectivity`` runs
    on sharded runs (the same tensors, on their device)."""
    return DenseHvState(active=st.active, passive=st.passive,
                        alive=st.alive, rnd=st.rnd, partition=st.partition)


def _state_type(s):
    if hasattr(s, "hv"):
        return ShardedDensePt
    return ShardedDenseScamp if hasattr(s, "in_view") else ShardedDenseHv


def state_from_numpy(s, device=None):
    """A reference sharded state (``ShardedDenseHv``, ``ShardedDensePt``
    or ``ShardedDenseScamp``, or anything with its fields, as numpy-
    convertible arrays in the global layout) as the port's, leaf for leaf,
    on ``device`` (None means the card)."""
    device = resolve_device(device)
    cls = _state_type(s)
    leaves = {}
    for f in cls._fields:
        x = getattr(s, f)
        if f == "hv":
            leaves[f] = state_from_numpy(x, device)
        else:
            dtype = np.bool_ if f == "alive" else np.int32
            leaves[f] = torch.from_numpy(np.array(x, dtype=dtype)).to(device)
    return cls(**leaves)


def state_to_numpy(s):
    """The inverse of ``state_from_numpy``: the same NamedTuple type
    holding numpy arrays, with an np.int32 round."""
    leaves = {}
    for f in type(s)._fields:
        x = getattr(s, f)
        if f == "hv":
            leaves[f] = state_to_numpy(x)
        elif f == "rnd":
            leaves[f] = np.int32(int(x))
        else:
            leaves[f] = x.cpu().numpy()
    return type(s)(**leaves)


# ---- shared round machinery -------------------------------------------

def _round_prng(seed_tag: int, cfg: Config, rnd: int, n: int, device):
    """(key, s32, rbits) of a round: the round key, scalar-salted uint32s
    as Python ints, and [n, w] per-(node, slot) bits from GLOBAL node ids
    (int32 holding the uint32s) — a node's coin flips do not depend on
    the shard count."""
    key = prng.fold_in(prng.PRNGKey(cfg.seed ^ seed_tag), rnd)

    def s32(salt: int) -> int:
        return int(prng.bits(prng.fold_in(key, salt)))

    def rbits(salt: int, w: int) -> torch.Tensor:
        assert w <= 256, "rbits packs the slot in 8 bits"
        ids = torch.arange(n, dtype=torch.int64, device=device)
        slots = torch.arange(w, dtype=torch.int64, device=device)
        return mix32(wrap_i32(((ids[:, None] << 8) | slots) ^ s32(salt)))
    return key, s32, rbits


def _hash_node(gids: torch.Tensor, salt: int, n: int) -> torch.Tensor:
    """``mix32(gid ^ salt) % n`` in uint32, never the node itself (the
    churn contact and the re-subscribe target)."""
    x = ((mix32(gids ^ i32(salt)).long() & MASK) % n).to(torch.int32)
    return torch.where(x == gids, (x + 1) % n, x)


class _Outbox:
    """The round's static outbox ``[N, slots, MAIL_COLS]``, filled one
    block of columns per emission site in the reference's order.  Dead
    senders emit nothing."""

    def __init__(self, gids, alive, part, slots: int):
        self.gids, self.alive, self.part = gids, alive, part
        self.mail = torch.zeros((gids.shape[0], slots, MAIL_COLS),
                                dtype=torch.int32, device=gids.device)
        self.at = 0

    def emit(self, dst, kind: int, pay=None):
        """``dst`` [N] or [N, b] GLOBAL destination ids (-1 = no mail),
        ``pay`` [N, b, k <= 10] payload columns."""
        d = dst[:, None] if dst.dim() == 1 else dst
        b = d.shape[1]
        v = (d >= 0) & self.alive[:, None]
        blk = self.mail[:, self.at:self.at + b]
        blk[..., 0] = v.to(torch.int32)
        blk[..., 1] = torch.where(v, d, 0)
        blk[..., 2] = self.gids[:, None]
        blk[..., 3] = kind
        blk[..., 4] = self.part[:, None]
        if pay is not None:
            blk[..., 5:5 + pay.shape[2]] = pay
        self.at += b

    def done(self, slots: int) -> torch.Tensor:
        assert self.at == slots, (self.at, slots)
        return self.mail.reshape(-1, MAIL_COLS)


class _Inbox:
    """Last round's mail delivered and routed: the exchange, the
    receive-side fault plane and the route, over every shard.  ``sel`` is
    ``[n_kinds, N, cap]`` indices into the flat ``[D * D*B]`` mailbox;
    ``src``/``p`` are its columns; ``routed`` and ``dropped`` are [D]."""

    def __init__(self, mail, mesh, n_loc, b_cap, alive, part, n_kinds,
                 sel_cap, salt):
        d = mesh.n_shards
        dev = alive.device
        recv, xdrop = bucket_exchange(
            mail.view(d, -1, MAIL_COLS), n_loc, d, b_cap, mesh)
        rdst, rkind, rpart = recv[..., 1], recv[..., 3], recv[..., 4]
        base = torch.arange(d, dtype=torch.int32, device=dev)[:, None]
        dstl = (rdst - base * n_loc).clamp(0, n_loc - 1)
        gdst = (dstl + base * n_loc).long()
        keep = (recv[..., 0] != 0) & alive[gdst] & (part[gdst] == rpart)
        sel, sel_drop = route_select(rkind, dstl, keep, n_kinds, n_loc,
                                     sel_cap, salt)   # [D, K, n_loc, cap]
        mbox = recv.shape[1]
        shift = (torch.arange(d, dtype=torch.int32, device=dev)
                 * mbox).view(d, 1, 1, 1)
        sel = torch.where(sel >= 0, sel + shift, -1)
        self.routed = (sel >= 0).flatten(1).sum(1)
        self.sel = sel.transpose(0, 1).reshape(n_kinds, d * n_loc, sel_cap)
        flat = recv.reshape(-1, MAIL_COLS)
        self.src = flat[:, 2]
        self.p = flat[:, 5:]
        self.dropped = xdrop + sel_drop


def _per_shard(x: torch.Tensor, d: int) -> torch.Tensor:
    """[N, ...] -> [d] int32 sums over each shard's rows."""
    return x.reshape(d, -1).sum(1, dtype=torch.int32)


def _reduce_metrics(mesh, names, vals) -> Dict[str, torch.Tensor]:
    """ONE all-reduce of the stacked [D] per-shard metrics."""
    tot = mesh.all_reduce(torch.stack([v.to(torch.int32) for v in vals],
                                      dim=1))
    return {k: tot[i] for i, k in enumerate(names)}


def _counter_vals(counters, names, planes, d, n_loc):
    """The ``counters`` tap: each fn over each shard's planes ([n_loc]
    rows; ``rnd`` whole), stacked to [D]."""
    out = []
    for k in names:
        per = []
        for s in range(d):
            rows = slice(s * n_loc, (s + 1) * n_loc)
            local = {p: (v if p == "rnd" else v[rows])
                     for p, v in planes.items()}
            per.append(torch.as_tensor(counters[k](local),
                                       device=planes["alive"].device
                                       ).reshape(()))
        out.append(torch.stack(per))
    return out


def _interpose_unsupported(interpose):
    if interpose is not None:
        raise ValueError(
            "interpose= is not supported by the sharded dense round: "
            "the unsharded hooks see whole-[N] destination vectors, "
            "which do not exist on any shard.  Use chaos= (message/"
            "node fault schedules run shard-local) or the unsharded "
            "make_dense_round for interposition experiments.")


def _planes_unported(flight, chaos, control):
    for name, val in (("flight", flight), ("chaos", chaos),
                      ("control", control)):
        if val is not None:
            raise ValueError(
                f"make_sharded_dense_round: {name}= is not ported yet "
                f"(its plane is in ROADMAP A); pass {name}=None")


def _geometry(cfg: Config, mesh, slots: int, bucket_cap):
    d = mesh.n_shards
    n_loc = _check_shards(cfg.n_nodes, d)
    return d, n_loc, bucket_cap or default_bucket_cap(slots * n_loc, d)


# ---- hyparview / plumtree round ---------------------------------------

def make_sharded_dense_round(
    cfg: Config,
    mesh,
    *,
    model: str = "hyparview",
    churn: float = 0.0,
    skip: frozenset = frozenset(),
    phase_window: int = 1,
    shuffle_window: Optional[int] = None,
    resub_policy=None,
    chaos=None,
    flight=None,
    counters: Optional[Dict[str, Callable]] = None,
    bucket_cap: Optional[int] = None,
    interpose=None,
    root: int = 0,
    broadcast_interval: int = 5,
    graft_timeout: int = 1,
    control=None,
):
    """One sharded dense round, ``step(state, rnd=None) -> (state,
    metrics)``, over the virtual shards of ``mesh``.

    ``model`` is "hyparview", "plumtree" (the broadcast fold fused over
    the hyparview round, ShardedDensePt state) or "scamp"
    (ShardedDenseScamp).  ``skip`` suppresses phase emissions (the outbox
    layout stays static): {"promotion", "shuffle", "repair", "merge"} for
    hyparview, {"resub"} for scamp.  ``counters`` maps a name to
    ``fn(planes) -> scalar`` over one shard's planes, summed over the
    shards into the metrics.  ``resub_policy(lonely, rnd) -> keep`` gates
    the isolation re-subscribe; hooks get ``rnd`` as the state's 0-d
    tensor.  Each round makes exactly one ``mesh.all_to_all`` (the mail
    exchange) and one ``mesh.all_reduce`` (the metrics)."""
    _interpose_unsupported(interpose)
    _planes_unported(flight, chaos, control)
    if model == "scamp":
        return _make_sharded_scamp_round(
            cfg, mesh, churn=churn, skip=skip, resub_policy=resub_policy,
            counters=counters, bucket_cap=bucket_cap)
    if model not in ("hyparview", "plumtree"):
        raise ValueError(f"unknown model {model!r}: want 'hyparview', "
                         f"'plumtree' or 'scamp'")
    if not skip <= HV_SKIP:
        raise ValueError(f"unknown phase(s) in skip: {sorted(skip - HV_SKIP)}")
    pt = model == "plumtree"
    n = cfg.n_nodes
    a_cap, p_cap = cfg.max_active_size, cfg.max_passive_size
    slots = hv_mail_slots(cfg)
    d, n_loc, b_cap = _geometry(cfg, mesh, slots, bucket_cap)
    sel_cap = max(a_cap, 2)
    s_win = shuffle_window if shuffle_window is not None else phase_window
    ctr_names = tuple(sorted(counters)) if counters else ()

    def body_hv(st: ShardedDenseHv, pt_planes, rnd: int):
        active, passive, astamp = st.active, st.passive, st.astamp
        alive, part = st.alive, st.partition
        dev = active.device
        gids = torch.arange(n, dtype=torch.int32, device=dev)
        key, s32, rbits = _round_prng(HV_SEED, cfg, rnd, n, dev)
        if pt:
            seq, parent, pstale = pt_planes

        # ---- churn: restart in place through one random contact
        if churn > 0.0:
            reset = less_u32(rbits(0, 1)[:, 0], int(churn * (2 ** 32))) \
                & alive
            contact = _hash_node(gids, s32(1), n)
            active = torch.where(reset[:, None], -1, active)
            astamp = torch.where(reset[:, None], 0, astamp)
            passive = torch.where(reset[:, None], -1, passive)
            passive = _set_col0(passive,
                                torch.where(reset, contact, passive[:, 0]))

        # ---- deliver last round's mail: THE one all-to-all, one route
        box = _Inbox(st.mail, mesh, n_loc, b_cap, alive, part, HV_KINDS,
                     sel_cap, s32(2))
        sel, rsrc, rp = box.sel, box.src, box.p
        out = _Outbox(gids, alive, part, slots)
        demote = []

        # KEEPALIVE: refresh the per-slot stamp (failure detection)
        ka = sel[K_KEEPALIVE]                         # [N, sel_cap]
        ka_src = take_vals(rsrc, ka)
        hit = ((active[:, :, None] == ka_src[:, None, :])
               & (active >= 0)[:, :, None] & (ka_src >= 0)[:, None, :])
        astamp = torch.where(hit.any(2), rnd, astamp)
        if pt:
            ka_seq = take_vals(rp[:, 0], ka)          # -1 on empty slots

        # DISCONNECT: explicit eviction notice — drop + demote
        for j in range(2):
            sj = take_vals(rsrc, sel[K_DISCONNECT][:, j])
            hitj = (active == sj[:, None]) & (sj >= 0)[:, None]
            demote.append(torch.where(hitj.any(1), sj, -1)[:, None])
            active = torch.where(hitj, -1, active)

        # ACCEPT: my proposal succeeded — add the target two-sided
        for j in range(2):
            sj = take_vals(rsrc, sel[K_ACCEPT][:, j])
            active, ev, _ = ps.insert_evict_bits(active, sj,
                                                 rbits(5 + j, 1)[:, 0])
            astamp = torch.where((active == sj[:, None])
                                 & (sj >= 0)[:, None], rnd, astamp)
            demote.append(ev[:, None])
            out.emit(ev, K_DISCONNECT)

        # PROPOSE: accept when there is room or the proposer is isolated
        for j in range(2):
            idx = sel[K_PROPOSE][:, j]
            pj = take_vals(rsrc, idx)
            high = take_vals(rp[:, 0], idx) > 0
            room = (active >= 0).sum(1) < a_cap
            aj = (pj >= 0) & alive & (room | high)
            active, ev, _ = ps.insert_evict_bits(
                active, torch.where(aj, pj, -1), rbits(7 + j, 1)[:, 0])
            astamp = torch.where((active == pj[:, None]) & aj[:, None],
                                 rnd, astamp)
            demote.append(ev[:, None])
            out.emit(torch.where(aj, pj, -1), K_ACCEPT)
            out.emit(ev, K_DISCONNECT)

        # my own shuffle sample: me ++ k_a active ++ k_p passive
        my_samp = torch.cat([
            gids[:, None],
            ps.random_k_bits(active, rbits(11, a_cap), cfg.shuffle_k_active),
            ps.random_k_bits(passive, rbits(12, p_cap),
                             cfg.shuffle_k_passive)], dim=1)   # [N, 8]

        # SHUF: one walk hop per round, carried (origin, ttl, sample)
        for j in range(2):
            idx = sel[K_SHUF][:, j]
            origin = take_vals(rp[:, 0], idx)
            ttl = take_vals(rp[:, 1], idx)
            samp_in = take_rows(rp, idx)[:, 2:10]
            fwd = ps.random_member_bits(active, rbits(13 + j, a_cap),
                                        exclude=torch.stack([gids, origin],
                                                            dim=1))
            okr = idx >= 0
            can_fwd = okr & (ttl > 0) & (fwd >= 0)
            out.emit(torch.where(can_fwd, fwd, -1), K_SHUF,
                     pay=torch.cat([origin[:, None], (ttl - 1)[:, None],
                                    samp_in], dim=1)[:, None, :])
            acc = okr & ~can_fwd
            demote.append(torch.where(acc[:, None], samp_in, -1))
            out.emit(torch.where(acc, origin, -1), K_SHUF_REPLY,
                     pay=torch.cat([torch.zeros_like(my_samp[:, :2]),
                                    my_samp], dim=1)[:, None, :])

        # SHUF_REPLY: origin folds the endpoint's sample
        for j in range(2):
            demote.append(take_rows(rp, sel[K_SHUF_REPLY][:, j])[:, 2:10])

        # ---- repair: dead-row clear + keepalive-TTL prune
        if "repair" not in skip:
            active = torch.where(alive[:, None], active, -1)
            ttl_stale = (active >= 0) & ((rnd - astamp) > cfg.keepalive_ttl)
            demote.append(torch.where(ttl_stale, active, -1))
            active = torch.where(ttl_stale, -1, active)

        # ---- isolation re-subscribe (every round)
        lonely = (alive & ((active >= 0).sum(1) == 0)
                  & ((passive >= 0).sum(1) == 0))
        if resub_policy is not None:
            lonely = lonely & resub_policy(lonely, st.rnd)
        passive = _set_col0(passive, torch.where(
            lonely, _hash_node(gids, s32(40), n), passive[:, 0]))

        def due_in_window(interval, window):
            x = (rnd + gids) % interval
            return ((interval - x) % interval) < window

        # ---- promotion initiation
        sizes = (active >= 0).sum(1)
        isolated = sizes == 0
        due = due_in_window(cfg.random_promotion_interval, phase_window) \
            | isolated
        cand = ps.random_member_bits(passive, rbits(3, p_cap))
        cand = torch.where(ps.contains(active, cand), -1, cand)
        propose = alive & due & (sizes < a_cap) & (cand >= 0)
        if "promotion" in skip:
            propose = torch.zeros_like(propose)
        out.emit(torch.where(propose, cand, -1), K_PROPOSE,
                 pay=isolated.to(torch.int32)[:, None, None])

        # ---- shuffle initiation: first hop of the walk
        due_s = alive & due_in_window(cfg.shuffle_interval, s_win)
        t0 = ps.random_member_bits(active, rbits(30, a_cap))
        go = due_s & (t0 >= 0)
        if "shuffle" in skip:
            go = torch.zeros_like(go)
        out.emit(torch.where(go, t0, -1), K_SHUF,
                 pay=torch.cat([gids[:, None],
                                torch.full_like(gids[:, None], cfg.arwl - 1),
                                my_samp], dim=1)[:, None, :])

        # ---- plumtree fold (digest/deliver/graft off keepalive mail)
        pt_vals = []
        if pt:
            bump = (broadcast_interval > 0
                    and rnd % max(broadcast_interval, 1) == 0)
            if bump:
                seq = torch.where(gids == root, seq + 1, seq)
            known = torch.where(ka_seq >= 0, ka_seq, -1).max(1).values
            pmask = ((ka_src == parent[:, None]) & (parent >= 0)[:, None]
                     & (ka_seq >= 0))
            p_seq = torch.where(pmask, ka_seq, -1).max(1).values
            delivered = p_seq > seq
            seq = torch.maximum(seq, p_seq)
            parent_ok = (parent >= 0) & (active == parent[:, None]).any(1)
            behind = known > seq
            pstale = torch.where(behind & ~delivered, pstale + 1, 0)
            need = ((behind & (pstale >= graft_timeout))
                    | (behind & ~parent_ok))
            score = torch.where(
                ka_seq >= 0, ka_seq * 8 + lshr(rbits(60, sel_cap), 29),
                -(1 << 30))
            pick = torch.argmax(score, dim=1)      # the first maximum
            cand_p = torch.gather(ka_src, 1, pick[:, None])[:, 0]
            grafted = need & (cand_p >= 0) & (gids != root)
            parent = torch.where(grafted, cand_p, parent)
            parent = torch.where(gids == root, -1, parent)
            pt_vals = [_per_shard(behind, d), _per_shard(grafted, d)]

        # ---- keepalive emission (every round in plumtree mode: the seq
        # digest rides it)
        if pt:
            out.emit(active, K_KEEPALIVE,
                     pay=seq[:, None, None].expand(n, a_cap, 1))
        else:
            ka_due = ((rnd + gids) % cfg.keepalive_interval) == 0
            out.emit(torch.where(ka_due[:, None], active, -1), K_KEEPALIVE)

        # ---- single fused passive merge, priorities counted per shard
        if "merge" not in skip:
            passive = bulk_passive_merge(
                active, passive, torch.cat(demote, dim=1), gids,
                prng.fold_in(key, 50), rows=gids % n_loc)

        mail = out.done(slots)
        names = ["mail_sent", "mail_processed", "mail_dropped", "live",
                 "lonely"]
        vals = [_per_shard(mail[:, 0], d), box.routed, box.dropped,
                _per_shard(alive, d), _per_shard(lonely, d)]
        if pt:
            names += ["pt_behind", "pt_grafts"]
            vals += pt_vals
        if counters:
            names += list(ctr_names)
            vals += _counter_vals(
                counters, ctr_names,
                {"active": active, "passive": passive, "alive": alive,
                 "gids": gids, "rnd": st.rnd}, d, n_loc)
        metrics = _reduce_metrics(mesh, names, vals)
        st2 = ShardedDenseHv(
            active=active, passive=passive, astamp=astamp, alive=alive,
            partition=part, mail=mail, dropped=st.dropped + box.dropped,
            rnd=st.rnd + 1)
        return st2, ((seq, parent, pstale) if pt else None), metrics

    if pt:
        def step(st: ShardedDensePt, rnd: Optional[int] = None):
            rnd = int(st.hv.rnd) if rnd is None else rnd
            hv2, (seq, parent, pstale), m = body_hv(
                st.hv, (st.seq, st.parent, st.pstale), rnd)
            return ShardedDensePt(hv=hv2, seq=seq, parent=parent,
                                  pstale=pstale), m
        return step

    def step(st: ShardedDenseHv, rnd: Optional[int] = None):
        rnd = int(st.rnd) if rnd is None else rnd
        st2, _, m = body_hv(st, None, rnd)
        return st2, m
    return step


# ---- scamp round -------------------------------------------------------

def _make_sharded_scamp_round(cfg: Config, mesh, *, churn=0.0,
                              skip=frozenset(), resub_policy=None,
                              counters=None, bucket_cap=None,
                              max_age: int = 64, join_patience: int = 12):
    """SCAMP with walkers IN the mail.  ``join_patience`` rounds must
    pass after a (re)subscribe before an empty view re-subscribes
    again."""
    if not skip <= {"resub"}:
        raise ValueError(f"unknown phase(s) in skip: "
                         f"{sorted(skip - {'resub'})}")
    n = cfg.n_nodes
    p_cap, c_cap = walker_caps(cfg)
    slots = scamp_mail_slots(cfg)
    d, n_loc, b_cap = _geometry(cfg, mesh, slots, bucket_cap)
    sel_cap = 6
    ctr_names = tuple(sorted(counters)) if counters else ()
    exact = cfg.scamp_exact_keep_probability

    def step(st: ShardedDenseScamp, rnd: Optional[int] = None):
        rnd = int(st.rnd) if rnd is None else rnd
        partial, in_view = st.partial, st.in_view
        alive, part, last_join = st.alive, st.partition, st.last_join
        ins_drop, wexp, wtrunc, ivdrop = (
            st.insert_dropped, st.walk_expired, st.walk_truncated,
            st.in_view_dropped)
        dev = partial.device
        gids = torch.arange(n, dtype=torch.int32, device=dev)
        _, s32, rbits = _round_prng(SCAMP_SEED, cfg, rnd, n, dev)

        if churn > 0.0:
            reset = less_u32(rbits(0, 1)[:, 0], int(churn * (2 ** 32))) \
                & alive
            partial = torch.where(reset[:, None], -1, partial)
            in_view = torch.where(reset[:, None], -1, in_view)
            # backdate so the resub fold below re-joins immediately
            last_join = torch.where(reset, rnd - join_patience, last_join)

        box = _Inbox(st.mail, mesh, n_loc, b_cap, alive, part, SCAMP_KINDS,
                     sel_cap, s32(2))
        sel, rsrc, rp = box.sel, box.src, box.p
        out = _Outbox(gids, alive, part, slots)

        # NOTIFY: a holder admitted my subscription -> my in_view
        for j in range(4):
            hj = take_vals(rsrc, sel[S_NOTIFY][:, j])
            want = (hj >= 0) & ~ps.contains(in_view, hj)
            in_view, _, ins = ps.insert_evict(in_view, hj, None)
            ivdrop = ivdrop + (want & ~ins).to(torch.int32)

        # WALK: keep-coin at the holder, else hop (walker = the mail)
        for j in range(6):
            idx = sel[S_WALK][:, j]
            subj = take_vals(rp[:, 0], idx)
            age = take_vals(rp[:, 1], idx)
            okr = (idx >= 0) & alive & (subj >= 0)
            size_p = (partial >= 0).sum(1)
            if exact:
                pnum = 1.0 / (1.0 + size_p.to(torch.float32))
            else:
                pnum = torch.full((n,), 0.4, dtype=torch.float32,
                                  device=dev)
            coin = (lshr(rbits(20 + j, 1)[:, 0], 8).to(torch.float32)
                    * (1.0 / (1 << 24))) < pnum
            # an empty view always keeps (v2: the contact itself)
            keepw = okr & (coin | (size_p == 0)) & (subj != gids)
            present = ps.contains(partial, subj)
            partial, _, ins = ps.insert_evict(
                partial, torch.where(keepw & ~present, subj, -1), None)
            admitted = keepw & ~present & ins
            full_drop = keepw & ~present & ~ins
            ins_drop = ins_drop + full_drop.to(torch.int32)
            out.emit(torch.where(admitted, subj, -1), S_NOTIFY)
            # forward / retry / expire
            fwd_needed = okr & ~admitted
            age2 = age + 1
            die = fwd_needed & (age2 > max_age)
            wexp = wexp + die.to(torch.int32)
            tgt = ps.random_member_bits(partial, rbits(26 + j, p_cap))
            tgt = torch.where(tgt >= 0, tgt, gids)     # hold at self
            tgt = torch.where(full_drop, gids, tgt)    # retry next round
            out.emit(torch.where(fwd_needed & ~die, tgt, -1), S_WALK,
                     pay=torch.stack([subj, age2], dim=1)[:, None, :])

        # JOIN: spawn the walk fan at the contact (one copy per view
        # member + c extras, truncated to the walker cap, counted)
        for j in range(2):
            idx = sel[S_JOIN][:, j]
            subj = take_vals(rsrc, idx)
            okj = (idx >= 0) & alive & (subj >= 0)
            size_p = (partial >= 0).sum(1)
            extras = ps.random_k_bits(partial, rbits(32 + j, p_cap),
                                      cfg.scamp_c)
            mf = ps.members_first(torch.cat([partial, extras], dim=1))
            wtrunc = wtrunc + torch.where(
                okj, (mf[:, c_cap:] >= 0).sum(1), 0).to(torch.int32)
            fan = torch.where(okj[:, None], mf[:, :c_cap], -1)
            # empty contact view: the walker stays at the contact
            fan = _set_col0(fan, torch.where(okj & (size_p == 0), gids,
                                             fan[:, 0]))
            out.emit(fan, S_WALK, pay=torch.stack([
                subj[:, None].expand(n, c_cap),
                torch.zeros((n, c_cap), dtype=torch.int32, device=dev)],
                dim=2))

        # ---- (re)subscribe: empty view + patience elapsed
        lonely = (alive & ((partial >= 0).sum(1) == 0)
                  & ((rnd - last_join) >= join_patience))
        if "resub" in skip:
            lonely = torch.zeros_like(lonely)
        if resub_policy is not None:
            lonely = lonely & resub_policy(lonely, st.rnd)
        contact = _hash_node(gids, s32(40), n)
        partial = _set_col0(partial, torch.where(lonely, contact,
                                                 partial[:, 0]))
        last_join = torch.where(lonely, rnd, last_join)
        out.emit(torch.where(lonely, contact, -1), S_JOIN)

        # dead rows keep no views (restart-in-place rebuilds via churn)
        partial = torch.where(alive[:, None], partial, -1)
        in_view = torch.where(alive[:, None], in_view, -1)

        mail = out.done(slots)
        names = ["mail_sent", "mail_processed", "mail_dropped", "live",
                 "resubs"]
        vals = [_per_shard(mail[:, 0], d), box.routed, box.dropped,
                _per_shard(alive, d), _per_shard(lonely, d)]
        if counters:
            names += list(ctr_names)
            vals += _counter_vals(
                counters, ctr_names,
                {"partial": partial, "in_view": in_view, "alive": alive,
                 "gids": gids, "rnd": st.rnd}, d, n_loc)
        metrics = _reduce_metrics(mesh, names, vals)
        return ShardedDenseScamp(
            partial=partial, in_view=in_view, alive=alive, partition=part,
            last_join=last_join, insert_dropped=ins_drop,
            walk_expired=wexp, walk_truncated=wtrunc,
            in_view_dropped=ivdrop, mail=mail,
            dropped=st.dropped + box.dropped, rnd=st.rnd + 1), metrics
    return step


# ---- runners -----------------------------------------------------------

def _round_of(state) -> int:
    return int(state.hv.rnd if isinstance(state, ShardedDensePt)
               else state.rnd)


def run_sharded(step, state, n_rounds: int):
    """``n_rounds`` calls of a sharded step; reads the round once."""
    rnd = _round_of(state)
    for i in range(n_rounds):
        state, _ = step(state, rnd + i)
    return state


def run_sharded_chunked(step, state, n_rounds: int, cfg: Config = None):
    """The reference splits long runs into launch-capped scans to dodge a
    TPU worker fault; the port launches round by round and has no scan
    to cap, so this is :func:`run_sharded`."""
    return run_sharded(step, state, n_rounds)


def run_sharded_staggered(cfg: Config, mesh, state, n_blocks: int,
                          *, model: str = "hyparview", churn: float = 0.0,
                          k: int = 5, **kw):
    """The phase-staggered cadence over the sharded round.
    hyparview/plumtree: one 2k block is [promo+shuffle heavy, light x k-1,
    promo heavy, light x k-1] with due windows widened to k / 2k; light
    rounds still run the whole mail plane.  scamp: [heavy, light x k-1]
    where light only skips the re-subscribe fold (k=1 is the flat
    program).  Reads the round once and counts up on the host."""
    if model == "scamp":
        heavy = _make_sharded_scamp_round(cfg, mesh, churn=churn, **kw)
        light = _make_sharded_scamp_round(cfg, mesh, churn=churn,
                                          skip=frozenset({"resub"}), **kw)
        programs = [(heavy, 1), (light, k - 1)]
    else:
        if cfg.random_promotion_interval < k:
            raise ValueError("stagger coarser than the promotion interval")
        if cfg.shuffle_interval < 2 * k:
            raise ValueError("stagger coarser than the shuffle interval")
        mk = functools.partial(make_sharded_dense_round, cfg, mesh,
                               model=model, churn=churn, **kw)
        hps = mk(phase_window=k, shuffle_window=2 * k)
        hp = mk(phase_window=k, skip=frozenset({"shuffle"}))
        light = mk(skip=frozenset({"promotion", "shuffle"}))
        programs = [(hps, 1), (light, k - 1), (hp, 1), (light, k - 1)]

    def counted(program):
        return lambda c: (program(c[0], c[1])[0], c[1] + 1)

    state, _ = dense_cadence.block_scan(
        [(counted(p), length) for p, length in programs],
        (state, _round_of(state)), n_blocks)
    return state
