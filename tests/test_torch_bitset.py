"""The port's packed bitsets (partisan_tpu_torch/ops/bitset.py, int32
words) against partisan_tpu/ops/bitset.py (uint32 words), compared
through ``view(np.uint32)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu.ops import bitset as ref
from partisan_tpu_torch import prng
from partisan_tpu_torch.ops import bitset

N = 4 * 4096
RNG = np.random.default_rng(7)
WORDS = RNG.integers(0, 2 ** 32, N // 32, dtype=np.uint64).astype(np.uint32)


def as_t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


def as_u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_mix32_matches_reference():
    x = np.concatenate([WORDS, np.array([0, 1, 2 ** 31, 2 ** 32 - 1],
                                        np.uint32)])
    np.testing.assert_array_equal(np.asarray(ref.mix32(jnp.asarray(x))),
                                  as_u(bitset.mix32(as_t(x))))


@pytest.mark.parametrize("s", [0, 1, 31, 32, 33, 4095, 4096, N - 1])
def test_roll_bits_matches_reference(s):
    want = np.asarray(ref.roll_bits(jnp.asarray(WORDS), jnp.int32(s), N))
    np.testing.assert_array_equal(want,
                                  as_u(bitset.roll_bits(as_t(WORDS), s, N)))


@pytest.mark.parametrize("p", [0.01, 1.0 / 3.0, 0.5, 0.001])
def test_biased_bits_matches_reference(p):
    jk = jax.random.fold_in(jax.random.PRNGKey(1), 42)
    tk = prng.fold_in(prng.PRNGKey(1), 42)
    want = np.asarray(ref.biased_bits(jk, p, N // 32))
    np.testing.assert_array_equal(want,
                                  as_u(bitset.biased_bits(tk, p, N // 32)))


def test_from_mask_to_mask_match_reference():
    for n in (N, 100, 33):
        mask = RNG.random(n) < 0.3
        want = np.asarray(ref.from_mask(jnp.asarray(mask)))
        got = bitset.from_mask(torch.from_numpy(mask))
        np.testing.assert_array_equal(want, as_u(got))
        np.testing.assert_array_equal(
            np.asarray(ref.to_mask(jnp.asarray(want), n)),
            bitset.to_mask(got, n).numpy())


def test_count_and_unsigned_compare():
    assert bitset.count(as_t(WORDS)) == int(ref.count(jnp.asarray(WORDS)))
    a = WORDS[:256]
    for bound in (1, 2 ** 31 - 1, 2 ** 31, 3_000_000_000, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            bitset.less_u32(as_t(a), bound).numpy(), a < bound)
