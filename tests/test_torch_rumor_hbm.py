"""K4's plain version (partisan_tpu_torch/ops/rumor_kernel_hbm.py) against
``partisan_tpu.ops.rumor_kernel_hbm.rumor_run_hbm(..., interpret=True)``
at churn 0, where the reference is deterministic; bit for bit on packed
words.  One interpret call costs a few seconds here, so the grid is kept
to the shapes the reference's own tests use.  The K4 kernel itself is
held against its plain version on the card in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from partisan_tpu.models import demers as ref
from partisan_tpu.ops.rumor_kernel_hbm import rumor_run_hbm as ref_hbm
from partisan_tpu_torch.models import demers
from partisan_tpu_torch.ops import rumor_kernel_hbm

CELL = 4096


def packed_world(n, seed, hot_frac=0.5, dead_frac=0.1):
    rng = np.random.default_rng(seed)
    inf = rng.random(n) < 0.2
    return ref.rumor_pack(ref.RumorWorld(
        infected=jnp.asarray(inf),
        hot=jnp.asarray(inf & (rng.random(n) < hot_frac)),
        alive=jnp.asarray(rng.random(n) >= dead_frac), rnd=jnp.int32(seed)))


def check(pk, rounds, n, block_rows, all_alive):
    want = ref_hbm(pk, rounds, n, 2, 1, 0.0, block_rows, True, all_alive)
    got = rumor_kernel_hbm.rumor_run_hbm(
        demers.world_from_numpy(pk, device="cpu"), rounds, n, 2, 1, 0.0,
        block_rows, all_alive)
    got = demers.world_to_numpy(got)
    for f in ("infected", "hot", "alive", "rnd"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f), err_msg=f)


@pytest.mark.parametrize("all_alive", [False, True])
@pytest.mark.parametrize("rounds", [1, 2, 5])
def test_plain_matches_reference_one_row_blocks(rounds, all_alive):
    n = 2 * CELL
    check(packed_world(n, rounds), rounds, n, 1, all_alive)


@pytest.mark.parametrize("all_alive", [False, True])
def test_plain_matches_reference_two_row_blocks(all_alive):
    n = 4 * CELL
    check(packed_world(n, 11), 3, n, 2, all_alive)


def test_plain_matches_reference_one_round_late_restart():
    """No hot sender at the start: round 0 counts zero, round 1 reseeds."""
    n = 2 * CELL
    check(packed_world(n, 5, hot_frac=0.0), 4, n, 1, False)


def test_block_rows_contract():
    n = 4 * CELL
    w = demers.world_from_numpy(packed_world(n, 1), device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        rumor_kernel_hbm.rumor_run_hbm(w, 1, n, block_rows=3)

