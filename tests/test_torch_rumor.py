"""The port's rumor path (partisan_tpu_torch/models/demers.py and K3 in
ops/rumor_kernel.py) against partisan_tpu/models/demers.py.

Every comparison is exact: the state is integer and the port draws its
randomness from the bit-exact threefry port.  Worlds cross as numpy
arrays through ``world_from_numpy`` / ``world_to_numpy``.  The K3 kernel
itself is held against its plain version on the card in
test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu.models import demers as ref
from partisan_tpu_torch.models import demers

N = 8192
ROUNDS = 60
FIELDS = ("infected", "hot", "alive", "rnd")


def assert_same(want, got):
    got = demers.world_to_numpy(got)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f), err_msg=f)


def random_world(n, seed, hot_frac=0.5, dead_frac=0.1, rnd=0):
    rng = np.random.default_rng(seed)
    inf = rng.random(n) < 0.2
    return ref.RumorWorld(
        infected=jnp.asarray(inf),
        hot=jnp.asarray(inf & (rng.random(n) < hot_frac)),
        alive=jnp.asarray(rng.random(n) >= dead_frac), rnd=jnp.int32(rnd))


@pytest.mark.parametrize("churn", [0.0, 0.01])
@pytest.mark.parametrize("stop_k", [1, 3])
@pytest.mark.parametrize("variant", ["shift", "uniform", "packed"])
def test_rumor_run_matches_reference(variant, stop_k, churn):
    w = ref.rumor_init(N, 5)
    want = ref.rumor_run(w, ROUNDS, N, 2, stop_k, churn, variant)
    got = demers.rumor_run(demers.world_from_numpy(w, device="cpu"), ROUNDS,
                           N, 2, stop_k, churn, variant)
    assert_same(want, got)


@pytest.mark.parametrize("churn", [0.0, 0.01])
@pytest.mark.parametrize("stop_k", [1, 3])
def test_fused_plain_matches_reference_packed(stop_k, churn):
    """On a CPU tensor "fused" runs K3's plain version; it must equal the
    reference's packed scan bit for bit."""
    w = ref.rumor_init(N, 5)
    want = ref.rumor_run(w, ROUNDS, N, 2, stop_k, churn, "packed")
    got = demers.rumor_run(demers.world_from_numpy(w, device="cpu"), ROUNDS,
                           N, 2, stop_k, churn, "fused")
    assert_same(want, got)


def test_packed_random_world_with_dead_nodes_and_restart():
    """A world with dead nodes and no hot sender: the first round must
    restart the rumor at the drawn patient zero, as the reference does."""
    w = random_world(N, 3, hot_frac=0.0, rnd=41)
    want = ref.rumor_run(w, 25, N, 2, 1, 0.01, "packed")
    got = demers.rumor_run(demers.world_from_numpy(w, device="cpu"), 25, N,
                           2, 1, 0.01, "fused")
    assert_same(want, got)


def test_packed_world_round_trip():
    w = ref.rumor_pack(random_world(N, 4, rnd=9))
    t = demers.world_from_numpy(w, device="cpu")
    assert isinstance(t, demers.RumorWorldPacked)
    assert t.infected.dtype == torch.int32
    assert_same(w, t)
    assert_same(ref.rumor_unpack(w, N), demers.rumor_unpack(t, N))


def test_unknown_variant_names_fused():
    w = demers.rumor_init(N, 0, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        demers.rumor_run(w, 1, N, variant="pallas")

