"""The port's dense HyParView round (partisan_tpu_torch/models/
hyparview_dense.py) against partisan_tpu/models/hyparview_dense.py, bit
for bit: init, every leaf after every round of the every-round program
with churn, the staggered cadence, the fault plane (partition, interpose
and re-subscribe hooks) and the health readout.  States cross as numpy
arrays through ``state_from_numpy`` / ``state_to_numpy``."""

import numpy as np
import pytest
import torch

import partisan_tpu as pt
from partisan_tpu.models import hyparview_dense as ref
from partisan_tpu_torch.config import Config
from partisan_tpu_torch.models import hyparview_dense as hd

N = 256
FIELDS = ("active", "passive", "alive", "rnd", "partition")


def assert_same(want, got, what=""):
    got = hd.state_to_numpy(got)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f), err_msg=f"{what} {f}")


def configs(**kw):
    return pt.Config(n_nodes=N, **kw), Config(n_nodes=N, **kw)


def health(h):
    return {k: float(np.asarray(v)) for k, v in h.items()}


@pytest.mark.parametrize("seed,spn", [(1, 2), (7, 3), (123456, 1)])
def test_dense_init_matches(seed, spn):
    rcfg, cfg = configs(seed=seed)
    assert_same(ref.dense_init(rcfg, spn), hd.dense_init(cfg, spn, "cpu"))


@pytest.fixture(scope="module")
def churned():
    """30 every-round rounds at 1% churn, both sides stepped one round at
    a time and compared after every round."""
    rcfg, cfg = configs()
    rstep = ref.make_dense_round(rcfg, 0.01)
    step = hd.make_dense_round(cfg, 0.01)
    a, b = ref.dense_init(rcfg), hd.dense_init(cfg, device="cpu")
    trail = []
    for r in range(30):
        a, b = rstep(a), step(b)
        trail.append((a, b))
    return rcfg, cfg, trail


@pytest.mark.parametrize("chunk", range(3))
def test_every_round_with_churn_matches_each_round(churned, chunk):
    _, _, trail = churned
    for r in range(10 * chunk, 10 * chunk + 10):
        assert_same(*trail[r], what=f"round {r}")


def test_staggered_cadence_matches(churned):
    rcfg, cfg, trail = churned
    a, b = trail[-1]
    want = ref.run_dense_staggered(a, 4, rcfg, 0.01, 5)
    got = hd.run_dense_staggered(b, 4, cfg, 0.01, 5)
    assert int(got.rnd) == 30 + 40
    assert_same(want, got, "staggered")
    assert_same(want, hd.run_dense_staggered_chunked(b, 4, cfg, 0.01, 5))


def test_connectivity_matches(churned):
    _, _, trail = churned
    for r in (0, 29):
        a, b = trail[r]
        assert health(ref.connectivity(a)) == health(hd.connectivity(b))


def test_fault_plane_matches():
    """faults=True with a two-way partition, an interposition hook that
    drops some promotions and shuffles, and a re-subscribe policy."""
    rcfg, cfg = configs(shuffle_interval=4, random_promotion_interval=2)

    def interpose(phase, dst, rnd):
        drop = 3 if phase == "promote" else 5
        return (dst % drop != 0) | (rnd % 4 == 0)

    def resub(lonely, rnd):
        return (rnd % 2 == 0) | ~lonely

    part = (np.arange(N) >= N // 2).astype(np.int32) + 1
    a = ref.run_dense(ref.dense_init(rcfg), 6, rcfg)
    b = hd.state_from_numpy(a, device="cpu")
    assert_same(a, b, "carried in")
    a = a.replace(partition=np.asarray(part))
    b = b._replace(partition=torch.from_numpy(part))
    rstep = ref.make_dense_round(rcfg, 0.01, faults=True, interpose=interpose,
                                 resub_policy=resub)
    step = hd.make_dense_round(cfg, 0.01, faults=True, interpose=interpose,
                               resub_policy=resub)
    for r in range(10):
        a, b = rstep(a), step(b)
        assert_same(a, b, f"faults round {r}")
    got = hd.state_to_numpy(b)
    for i in range(N):      # no edge crosses the partition after repair
        peers = got.active[i][got.active[i] >= 0]
        assert (part[peers] == part[i]).all(), i


def test_carry_across_round_trips():
    rcfg, cfg = configs(seed=5)
    a = ref.run_dense(ref.dense_init(rcfg), 3, rcfg)
    b = hd.state_from_numpy(a, device="cpu")
    back = hd.state_to_numpy(b)
    assert_same(a, hd.state_from_numpy(back, device="cpu"))
    assert back.rnd.dtype == np.int32 and back.active.dtype == np.int32


def test_round_checks_its_arguments():
    cfg = Config(n_nodes=64)
    with pytest.raises(ValueError, match="unknown phase"):
        hd.make_dense_round(cfg, skip=frozenset({"gossip"}))
    with pytest.raises(ValueError, match="staggered cadence"):
        hd.staggered_programs(cfg.replace(shuffle_interval=4), 0.0, 5)
