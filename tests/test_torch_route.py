"""The port's proposal router (partisan_tpu_torch/ops/shard_exchange.py
``reverse_select`` and the plain version of K1 in ops/route_kernel.py)
against partisan_tpu/ops/shard_exchange.py ``reverse_select`` and its
Pallas twin in interpret mode.  Targets come from a numpy seed (80% in
range, the rest -1 or just outside [0, n)); every comparison is exact.
The K1 CUDA kernel itself is held against the plain version on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu.ops import shard_exchange as ref
from partisan_tpu.ops.route_kernel import reverse_select_kernel
from partisan_tpu_torch.ops import route_kernel, shard_exchange

rng = np.random.default_rng(20261016)
RANDOM = [(int(rng.integers(1, 3000)), int(rng.integers(2, 2000)),
           1 + i % 5, int(rng.integers(0, 2 ** 32))) for i in range(12)]
EDGES = [(1, 1, 1, 7), (1, 5, 2, 7), (2, 2, 1, 7), (64, 8, 4, 7),
         (257, 3, 2, 7), (4096, 4096, 2, 0xFFFFFFFF), (4097, 100, 3, 1)]


def targets(m, n, seed):
    g = np.random.default_rng(seed)
    t = g.integers(-2, n + 2, m)
    return np.where(g.random(m) < 0.8, t, -1).astype(np.int32)


ref_select = jax.jit(ref.reverse_select, static_argnums=(2, 3))


def port(t, salt, n, c):
    return shard_exchange.reverse_select(torch.from_numpy(t), salt, n, c
                                         ).numpy()


@pytest.mark.parametrize("m,n,c,salt", RANDOM + EDGES)
def test_matches_reference(m, n, c, salt):
    t = targets(m, n, m * 131 + n)
    want = np.asarray(ref_select(jnp.asarray(t), jnp.uint32(salt), n, c))
    np.testing.assert_array_equal(want, port(t, salt, n, c))


@pytest.mark.parametrize("case", ["all_invalid", "overflow", "few_bits"])
def test_special_inputs_match_reference(case):
    if case == "all_invalid":
        t, n, c = np.full(9, -1, np.int32), 4, 2
    elif case == "overflow":          # everyone proposes to node 0
        t, n, c = np.zeros(40, np.int32), 6, 3
    else:                             # 7 tiebreak bits, crowded targets
        n, c = (1 << 23) + 5, 1
        t = targets(500, n, 3)
        t = np.where(t >= 0, t % 50 * ((1 << 17) + 1), -1).astype(np.int32)
    want = np.asarray(ref_select(jnp.asarray(t), jnp.uint32(11), n, c))
    got = port(t, 11, n, c)
    np.testing.assert_array_equal(want, got)
    if case == "overflow":
        assert (got >= 0).sum() == 3


def test_matches_the_pallas_twin_in_interpret_mode():
    t = targets(48, 10, 5)
    want = np.asarray(reverse_select_kernel(jnp.asarray(t), jnp.uint32(99),
                                            10, 3, interpret=True))
    np.testing.assert_array_equal(want, port(t, 99, 10, 3))


def test_refuses_n_beyond_the_packed_key():
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="n < 2\\^27"):
        shard_exchange.reverse_select(t, 0, 1 << 27, 2)
    with pytest.raises(ValueError, match="reverse_select: n="):
        ref.reverse_select(jnp.zeros(4, jnp.int32), jnp.uint32(0),
                           1 << 27, 2)


@pytest.mark.parametrize("bad", ["int64", "2d", "strided", "c0", "n0",
                                 "slots", "empty"])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad):
    t = torch.zeros(8, dtype=torch.int32)
    n, c = 4, 2
    if bad == "int64":
        t = t.long()
    elif bad == "2d":
        t = t.reshape(2, 4)
    elif bad == "strided":
        t = torch.zeros(16, dtype=torch.int32)[::2]
    elif bad == "c0":
        c = 0
    elif bad == "n0":
        n = 0
    elif bad == "slots":
        n, c = (1 << 27) - 1, 32
    else:
        t = t[:0]
    before = route_kernel.LAUNCHES
    for fn in (route_kernel.reverse_select_kernel,
               route_kernel.reverse_select_cuda):
        with pytest.raises(ValueError):
            fn(t, 0, n, c)
    assert route_kernel.LAUNCHES == before
