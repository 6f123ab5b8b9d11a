"""The port's batched padded sets (partisan_tpu_torch/ops/padded_set.py)
against ``jax.vmap`` of partisan_tpu/ops/padded_set.py over the same rows.

Rows are random [ROWS, C] views: distinct ids with -1 holes (several -1s
per row), made from a numpy seed.  Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu.ops import padded_set as ref
from partisan_tpu_torch import prng
from partisan_tpu_torch.ops import padded_set as ps

ROWS = 97
CAPS = [1, 4, 6, 30]


def views(cap, seed, fill=0.6, universe=64):
    rng = np.random.default_rng(seed)
    out = np.full((ROWS, cap), -1, np.int32)
    for r in range(ROWS):
        ids = rng.permutation(universe)[:cap]
        keep = rng.random(cap) < (fill if r % 7 else 1.0)   # some full rows
        out[r] = np.where(keep, ids, -1)
    return out


def u32_bits(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def scalars(s, seed):
    """Per-row ids: members, absent ids and -1."""
    rng = np.random.default_rng(seed)
    pick = s[np.arange(ROWS), rng.integers(0, s.shape[1], ROWS)]
    other = rng.integers(-1, 80, ROWS).astype(np.int32)
    return np.where(rng.random(ROWS) < 0.5, pick, other).astype(np.int32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def eq(want, got):
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            eq(w, g)
        return
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("cap", CAPS)
def test_elementwise_helpers(cap):
    s = views(cap, cap)
    x = scalars(s, cap + 1)
    js, jx = jnp.asarray(s), jnp.asarray(x)
    eq(jax.vmap(ref.valid_mask)(js), ps.valid_mask(t(s)))
    eq(jax.vmap(ref.size)(js), ps.size(t(s)))
    eq(jax.vmap(ref.contains)(js, jx), ps.contains(t(s), t(x)))
    eq(jax.vmap(ref.remove)(js, jx), ps.remove(t(s), t(x)))
    eq(jax.vmap(ref.insert)(js, jx), ps.insert(t(s), t(x)))
    eq(jax.vmap(ref.members_first)(js), ps.members_first(t(s)))
    eq(jnp.broadcast_to(ref.make(cap), (3, cap)), ps.make(cap, (3,)))
    sel = np.random.default_rng(cap).random((ROWS, cap)) < 0.4
    eq(jax.vmap(ref._first_match_value)(jnp.asarray(sel), js),
       ps._first_match_value(t(sel), t(s)))


@pytest.mark.parametrize("cap", CAPS)
def test_insert_evict_variants(cap):
    s = views(cap, 10 + cap)
    x = scalars(s, 20 + cap)
    js, jx = jnp.asarray(s), jnp.asarray(x)
    bits = u32_bits(ROWS, 30 + cap)
    want = jax.vmap(ref.insert_evict_bits)(js, jx, jnp.asarray(bits))
    eq(want, ps.insert_evict_bits(t(s), t(x), t(bits.view(np.int32))))
    eq(want, ps.insert_evict_bits(t(s), t(x), t(bits.astype(np.int64))))
    jkeys = jax.random.split(jax.random.PRNGKey(cap), ROWS)
    tkeys = prng.split(prng.PRNGKey(cap), ROWS)
    eq(jax.vmap(ref.insert_evict)(js, jx, jkeys),
       ps.insert_evict(t(s), t(x), tkeys))
    eq(jax.vmap(lambda a, b: ref.insert_evict(a, b, None))(js, jx),
       ps.insert_evict(t(s), t(x), None))


@pytest.mark.parametrize("cap", CAPS)
def test_random_member_variants(cap):
    s = views(cap, 40 + cap)
    js = jnp.asarray(s)
    bits = u32_bits((ROWS, cap), 50 + cap)
    jb, tb = jnp.asarray(bits), t(bits.view(np.int32))
    eq(jax.vmap(ref.random_member_bits)(js, jb), ps.random_member_bits(t(s), tb))
    ex1 = scalars(s, 60 + cap)
    eq(jax.vmap(ref.random_member_bits)(js, jb, jnp.asarray(ex1)),
       ps.random_member_bits(t(s), tb, exclude=t(ex1)))
    ex2 = np.stack([ex1, scalars(s, 70 + cap)], axis=1)
    eq(jax.vmap(ref.random_member_bits)(js, jb, jnp.asarray(ex2)),
       ps.random_member_bits(t(s), tb, exclude=t(ex2)))
    jkeys = jax.random.split(jax.random.PRNGKey(80 + cap), ROWS)
    tkeys = prng.split(prng.PRNGKey(80 + cap), ROWS)
    eq(jax.vmap(ref.random_member)(js, jkeys), ps.random_member(t(s), tkeys))
    eq(jax.vmap(ref.random_member)(js, jkeys, jnp.asarray(ex2)),
       ps.random_member(t(s), tkeys, exclude=t(ex2)))


@pytest.mark.parametrize("cap", CAPS)
def test_random_k_variants(cap):
    s = views(cap, 90 + cap)
    js = jnp.asarray(s)
    # equal high bits in a few slots: ties must keep slot order (stable)
    bits = u32_bits((ROWS, cap), 100 + cap)
    bits[::5] &= np.uint32(0xFFFF0001)
    jb, tb = jnp.asarray(bits), t(bits.view(np.int32))
    for k in sorted({1, min(3, cap), cap}):
        eq(jax.vmap(lambda a, b: ref.random_k_bits(a, b, k))(js, jb),
           ps.random_k_bits(t(s), tb, k))
        ex = scalars(s, 110 + cap + k)
        eq(jax.vmap(lambda a, b, e: ref.random_k_bits(a, b, k, e))(
            js, jb, jnp.asarray(ex)),
           ps.random_k_bits(t(s), tb, k, exclude=t(ex)))
        jkeys = jax.random.split(jax.random.PRNGKey(k), ROWS)
        tkeys = prng.split(prng.PRNGKey(k), ROWS)
        eq(jax.vmap(lambda a, kk: ref.random_k(a, kk, k))(js, jkeys),
           ps.random_k(t(s), tkeys, k))
