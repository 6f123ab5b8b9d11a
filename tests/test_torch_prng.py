"""The port's ``jax.random`` subset (partisan_tpu_torch/prng.py) against
``jax.random`` itself: bit-exact keys, bits and randint for the seeds,
batch shapes and ranges that the rumor path draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu import prng as ref_prng
from partisan_tpu_torch import prng

SEEDS = [int(s) for s in
         np.random.default_rng(20261016).integers(0, 2 ** 31, 46)]
SEEDS += [0, 1, 0xB10C, 2 ** 31 - 1]
# [1, n), [0, n), [0, R), [1, 4096), [0, 2^30) on the rumor path
RANGES = [(1, 1 << 20), (0, 1 << 20), (0, 4096), (1, 4096), (0, 1 << 30),
          (1, 8192), (0, 2)]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_randint_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), u32(tk))
    for d in (0, 7, seed % 100_000):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jk, d)), u32(prng.fold_in(tk, d)))
    for num in (2, 3, 4):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, num)),
                                      u32(prng.split(tk, num)))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (), jnp.uint32)), u32(prng.bits(tk)))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (5, 3), jnp.uint32)),
        u32(prng.bits(tk, (5, 3))))
    for lo, hi in RANGES:
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, (3, 2), lo, hi)),
            prng.randint(tk, (3, 2), lo, hi).numpy(), err_msg=f"{lo}, {hi}")


def test_batched_round_keys_match_vmapped_jax():
    """A whole run's per-round draws in one pass: fold_in over a batch of
    rounds, then split / randint / bits over the key batch."""
    rounds = np.arange(1000, 1257)
    jk = jax.vmap(lambda r: jax.random.fold_in(jax.random.PRNGKey(1), r))(
        jnp.asarray(rounds))
    tk = prng.fold_in(prng.PRNGKey(1), torch.from_numpy(rounds))
    np.testing.assert_array_equal(np.asarray(jk), u32(tk))
    jks = jax.vmap(lambda k: jax.random.split(k, 3))(jk)
    tks = prng.split(tk, 3)
    np.testing.assert_array_equal(np.asarray(jks), u32(tks))
    for lo, hi in RANGES:
        want = jax.vmap(lambda k: jax.random.randint(k, (2,), lo, hi))(
            jks[:, 0])
        np.testing.assert_array_equal(
            np.asarray(want), prng.randint(tks[:, 0], (2,), lo, hi).numpy())
    want = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(jks[:, 1])
    np.testing.assert_array_equal(np.asarray(want), u32(prng.bits(tks[:, 1])))
    want = jax.vmap(lambda k: jax.random.randint(
        jax.random.fold_in(k, 7), (), 0, 1 << 20))(jk)
    np.testing.assert_array_equal(
        np.asarray(want),
        prng.randint(prng.fold_in(tk, 7), (), 0, 1 << 20).numpy())


def test_large_shape_randint_matches_jax():
    """The K4 table draws one key over a [rounds, fanout] shape."""
    key = jax.random.fold_in(jax.random.PRNGKey(0xB10C), 17)
    tkey = prng.fold_in(prng.PRNGKey(0xB10C), 17)
    for shape, lo, hi in (((300, 2), 0, 4096), ((300, 2), 1, 4096),
                          ((300,), 0, 1 << 24), ((300,), 0, 1 << 30)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(key, shape, lo, hi)),
            prng.randint(tkey, shape, lo, hi).numpy())


def test_node_round_decision_keys_match_reference():
    np.testing.assert_array_equal(np.asarray(ref_prng.node_keys(3, 64)),
                                  u32(prng.node_keys(3, 64)))
    jk = ref_prng.node_keys(3, 64)
    tk = prng.node_keys(3, 64)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: ref_prng.round_key(k, 11))(jk)),
        u32(prng.round_key(tk, 11)))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: ref_prng.decision_key(k, 5))(jk)),
        u32(prng.decision_key(tk, 5)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.7), (1e-3, 1e3),
                                   (5.0, 6.0)])
def test_uniform_matches_jax(lo, hi):
    """float32 ``uniform`` bit for bit, for a single key (hashed from its
    words) and a key batch, including jax's fused scale-and-shift."""
    for seed in SEEDS[:8]:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        want = np.asarray(jax.random.uniform(jk, (4096,), minval=lo,
                                             maxval=hi))
        tk = prng.fold_in(prng.PRNGKey(seed), 3)
        for key, dev in ((tk, None), (tk, "cpu"), (tk[None], None)):
            got = prng.uniform(key, (4096,), lo, hi, device=dev).numpy()
            np.testing.assert_array_equal(want.view(np.uint32),
                                          got.reshape(-1).view(np.uint32))
    keys = jax.random.split(jax.random.PRNGKey(1), 5)
    want = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=lo,
                                                 maxval=hi))(keys)
    got = prng.uniform(prng.split(prng.PRNGKey(1), 5), (3,), lo, hi)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))


def test_single_cpu_key_matches_key_batch():
    """One key on the CPU is hashed from its words as Python ints (the
    dense rounds' per-round keys): fold_in, split, bits and randint give
    what the tensor path gives for the same key as a batch of one."""
    for seed in SEEDS[:8]:
        tk = prng.PRNGKey(seed ^ 0xDE45E)
        for d in (0, 17, 2 ** 31 - 1, 2 ** 32 - 1):
            tk2, tb = prng.fold_in(tk, d), prng.fold_in(tk[None], d)
            assert tk2.dtype == torch.int64 and tk2.shape == (2,)
            np.testing.assert_array_equal(tk2.numpy(), tb[0].numpy())
            assert int(prng.bits(tk2)) == int(prng.bits(tb)[0])
            np.testing.assert_array_equal(prng.split(tk2, 3).numpy(),
                                          prng.split(tb, 3)[0].numpy())
            np.testing.assert_array_equal(
                prng.randint(tk2, (257,), 0, 1 << 20).numpy(),
                prng.randint(tb, (257,), 0, 1 << 20)[0].numpy())
            np.testing.assert_array_equal(
                prng.bits(tk2, (5, 3), device="cpu").numpy(),
                prng.bits(tb, (5, 3))[0].numpy())
