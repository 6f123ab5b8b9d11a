"""Fixed-capacity padded integer sets with sentinel -1 — the counterpart of
``partisan_tpu/ops/padded_set.py``.

The reference writes each function for ONE row (a single node's view,
``[C]`` int32) and ``jax.vmap``-s it over the node axis.  Here every
function takes ``[..., C]`` rows and works on the last axis, so a whole
view table is one call with no loop over rows.  Scalars per row (``x``,
the eviction draw, an excluded id) have shape ``[...]``; ``exclude`` may
also be ``[..., E]``.

Random bits come in as uint32 values carried by int32 or int64 tensors
(``ops.bitset.mix32`` output, or ``prng.bits``); ``_u32`` reads either.
The key-based variants draw through ``prng`` with one key per row
(``[..., 2]``).  Results are bit-exact with ``jax.vmap`` of the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import prng

EMPTY = -1
MASK = 0xFFFFFFFF


def _u32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int32 (two's complement) or int64 -> int64."""
    return bits.long() & MASK


def _slots(s: torch.Tensor) -> torch.Tensor:
    return torch.arange(s.shape[-1], device=s.device)


def make(cap: int, rows=(), device=None) -> torch.Tensor:
    return torch.full((*tuple(rows), cap), EMPTY, dtype=torch.int32,
                      device=device)


def valid_mask(s: torch.Tensor) -> torch.Tensor:
    return s >= 0


def size(s: torch.Tensor) -> torch.Tensor:
    return (s >= 0).sum(-1).to(torch.int32)


def contains(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ((s == x.unsqueeze(-1)) & (x >= 0).unsqueeze(-1)).any(-1)


def remove(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    hit = (s == x.unsqueeze(-1)) & (x >= 0).unsqueeze(-1)
    return torch.where(hit, EMPTY, s)


def insert(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Insert ``x`` if absent and there is a free slot; silently no-op
    otherwise (including x < 0).  Returns the new set."""
    new, _, _ = insert_evict(s, x, None)
    return new


def _first_match_value(sel: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Value of the first slot where ``sel`` (0 where none), as a one-hot
    reduction.  The reference marks the first slot with a running count;
    here ``argmax`` finds it: on the card a scan along a last axis of a
    few slots is slow (such cumsums were 40% of the card's busy time in a
    profiled N=2^20 dense block, chip_smoke.py phase 8, H100)."""
    first = sel & (_slots(s) == torch.argmax(sel.to(torch.int32), dim=-1,
                                             keepdim=True))
    return torch.where(first, s, 0).sum(-1).to(torch.int32)


def _free_slots(s: torch.Tensor):
    """(has_free, first_free): ``argmax`` of an int tensor returns the
    first maximum, as ``jnp.argmax`` does."""
    free = s < 0
    return free.any(-1), torch.argmax(free.to(torch.int32), dim=-1)


def _place(s, x, slot, do, evict):
    """Write ``x`` at ``slot`` where ``do``; the evicted value is read
    one-hot where ``evict``."""
    at = _slots(s) == slot.unsqueeze(-1)
    evicted = torch.where(evict, _first_match_value(at, s), EMPTY)
    new = torch.where(at & do.unsqueeze(-1), x.unsqueeze(-1), s)
    return new, evicted.to(torch.int32), do


def insert_evict(s: torch.Tensor, x: torch.Tensor, key
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert ``x``; when the set is full evict a uniformly random victim
    (the ``add_to_active_view`` drop, hyparview :1466-1512).  ``key`` is
    one key per row (``[..., 2]``) or None: no eviction, a full set
    refuses the insert.  Returns ``(new_set, evicted, inserted)``."""
    want = (x >= 0) & ~contains(s, x)
    has_free, first_free = _free_slots(s)
    if key is None:
        return _place(s, x, first_free, want & has_free,
                      torch.zeros_like(want))
    rand_slot = prng.randint(key, (), 0, s.shape[-1]).long()
    slot = torch.where(has_free, first_free, rand_slot)
    return _place(s, x, slot, want, want & ~has_free)


def insert_evict_bits(s: torch.Tensor, x: torch.Tensor,
                      rand32: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`insert_evict` with the eviction slot drawn from a caller-
    supplied uint32 per row: ``rand32 mod cap``, unsigned."""
    want = (x >= 0) & ~contains(s, x)
    has_free, first_free = _free_slots(s)
    rand_slot = _u32(rand32) % s.shape[-1]
    slot = torch.where(has_free, first_free, rand_slot)
    return _place(s, x, slot, want, want & ~has_free)


def _excluded(s: torch.Tensor, exclude) -> torch.Tensor:
    """[..., C] mask of slots holding an excluded id."""
    ex = torch.as_tensor(exclude, device=s.device)
    if ex.dim() < s.dim():
        ex = ex.unsqueeze(-1)
    return (s.unsqueeze(-1) == ex.unsqueeze(-2)).any(-1)


def _random_member_from_bits(s, bits, exclude) -> torch.Tensor:
    ok = s >= 0
    if exclude is not None:
        ok = ok & ~_excluded(s, exclude)
    # the reference's max of float32(bits >> 8): 24-bit integers, exact in
    # float32, so the integer max picks the same first slot
    f = torch.where(ok, _u32(bits) >> 8, -1)
    m = f.max(-1).values
    member = _first_match_value(ok & (f == m.unsqueeze(-1)), s)
    return torch.where(m >= 0, member, EMPTY).to(torch.int32)


def random_member(s: torch.Tensor, key: torch.Tensor, exclude=None
                  ) -> torch.Tensor:
    """Uniformly random member (or -1 when empty), optionally excluding
    ids — ``select_random(State, [exclude...])`` (hyparview :1346-1361)."""
    return _random_member_from_bits(s, prng.bits(key, s.shape[-1:]),
                                    exclude)


def random_member_bits(s: torch.Tensor, bits: torch.Tensor, exclude=None
                       ) -> torch.Tensor:
    """:func:`random_member` from caller-supplied uint32 bits (shape of
    ``s``)."""
    return _random_member_from_bits(s, bits, exclude)


def _payload_sort(key: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``lax.sort((key, s), num_keys=1)`` on the last axis: stable, so
    equal keys keep their input order; returns the sorted payload."""
    order = torch.sort(key, dim=-1, stable=True).indices
    return torch.gather(s, -1, order)


def _random_k_from_bits(s, bits, k: int, exclude) -> torch.Tensor:
    ok = s >= 0
    if exclude is not None:
        ok = ok & ~_excluded(s, exclude)
    # ascending random key (logical >> 1), invalid slots at 2^31
    key32 = torch.where(ok, _u32(bits) >> 1, 1 << 31)
    picked = _payload_sort(key32, s)[..., :k]
    rank_ok = torch.arange(k, device=s.device) < ok.sum(-1, keepdim=True)
    return torch.where(rank_ok, picked, EMPTY).to(torch.int32)


def random_k(s: torch.Tensor, key: torch.Tensor, k: int, exclude=None
             ) -> torch.Tensor:
    """Up to ``k`` distinct random members, -1 padded — the shuffle sample
    (``select_random_sublist``, hyparview :572-607, 1589-1595)."""
    return _random_k_from_bits(s, prng.bits(key, s.shape[-1:]), k, exclude)


def random_k_bits(s: torch.Tensor, bits: torch.Tensor, k: int,
                  exclude=None) -> torch.Tensor:
    """:func:`random_k` from caller-supplied uint32 bits."""
    return _random_k_from_bits(s, bits, k, exclude)


def members_first(s: torch.Tensor) -> torch.Tensor:
    """Compact valid members to the front (order preserved among
    members)."""
    cap = s.shape[-1]
    assert cap < (1 << 16), "members_first packs positions in 16 bits"
    key32 = torch.where(s >= 0, 0, 1 << 16) | _slots(s)
    return _payload_sort(key32, s)
