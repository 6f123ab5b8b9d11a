"""The port's sharded dense dataplane (partisan_tpu_torch/parallel/
dense_dataplane.py, D virtual shards on one device) against
partisan_tpu/parallel/dense_dataplane.py on the 8-device CPU mesh, bit for
bit at N=256, D=8: init, every leaf and every metric after every round of
the hyparview (40 rounds), plumtree (30) and scamp (40) rounds, the
staggered cadence, and the health readout through ``to_dense``.  States
cross as numpy arrays through ``state_from_numpy`` / ``state_to_numpy``.
The port's form of the reference's collective budget is a count: each
round makes exactly one ``all_to_all`` and one ``all_reduce``."""

import numpy as np
import pytest
import torch

import partisan_tpu as pt
from partisan_tpu.models.hyparview_dense import connectivity as ref_health
from partisan_tpu.parallel import dense_dataplane as ref
from partisan_tpu.parallel.mesh import make_mesh as ref_mesh
from partisan_tpu_torch.config import Config
from partisan_tpu_torch.models.hyparview_dense import connectivity
from partisan_tpu_torch.parallel import dense_dataplane as dd
from partisan_tpu_torch.parallel import mesh as port_mesh

D = 8
N = 256
HV = dict(n_nodes=N, shuffle_interval=4, random_promotion_interval=2)
# the reference's tests/test_dense_dataplane.py programs (HV_CFG at churn
# 0.02, plumtree at broadcast_interval 5, SC_CFG at churn 0.01)
MODELS = {
    "hyparview": (HV, dict(churn=0.02), 40),
    "plumtree": (HV, dict(model="plumtree", broadcast_interval=5), 30),
    "scamp": (dict(n_nodes=N), dict(model="scamp", churn=0.01), 40),
}
INITS = {"hyparview": "sharded_dense_init", "plumtree": "sharded_pt_init",
         "scamp": "sharded_scamp_init"}


def leaves(s, pre=""):
    """{name: numpy array} of a reference or port sharded state."""
    out = {}
    for f in dd._state_type(s)._fields:
        x = getattr(s, f)
        if f == "hv":
            out.update(leaves(x, "hv."))
        else:
            out[pre + f] = np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                      else x)
    return out


def assert_same(want, got, what=""):
    w, g = leaves(want), leaves(got)
    assert w.keys() == g.keys()
    for k in w:
        assert w[k].dtype == g[k].dtype, (what, k, w[k].dtype, g[k].dtype)
        np.testing.assert_array_equal(w[k], g[k], err_msg=f"{what} {k}")


def make(model):
    cfg_kw, kw, _ = MODELS[model]
    init = INITS[model]
    rcfg, cfg = pt.Config(**cfg_kw), Config(**cfg_kw)
    rm, pm = ref_mesh(n_devices=D), port_mesh.make_mesh(D, "cpu")
    a = ref.place_sharded(getattr(ref, init)(rcfg, D), rm)
    b = getattr(dd, init)(cfg, D, device="cpu")
    return (ref.make_sharded_dense_round(rcfg, rm, **kw), a,
            dd.make_sharded_dense_round(cfg, pm, **kw), b)


@pytest.fixture(scope="module", params=list(MODELS))
def trajectory(request):
    """Both sides stepped one round at a time; per round the reference's
    state and metrics, the port's, and the port's collective counts."""
    model = request.param
    rstep, a, step, b = make(model)
    trail = []
    for _ in range(MODELS[model][2]):
        before = (port_mesh.ALL_TO_ALL, port_mesh.ALL_REDUCE)
        a, ma = rstep(a)
        b, mb = step(b)
        counts = (port_mesh.ALL_TO_ALL - before[0],
                  port_mesh.ALL_REDUCE - before[1])
        trail.append((a, {k: int(v) for k, v in ma.items()},
                      dd.state_to_numpy(b), {k: int(v) for k, v in mb.items()},
                      counts))
    return model, trail


@pytest.mark.parametrize("chunk", range(4))
def test_every_leaf_and_metric_match_each_round(trajectory, chunk):
    model, trail = trajectory
    n = len(trail)
    for r in range(n * chunk // 4, n * (chunk + 1) // 4):
        a, ma, b, mb, _ = trail[r]
        assert_same(a, b, f"{model} round {r}")
        assert ma == mb, (model, r, ma, mb)


def test_one_exchange_and_one_reduction_a_round(trajectory):
    model, trail = trajectory
    assert [t[4] for t in trail] == [(1, 1)] * len(trail), model


def test_mail_flows_and_is_counted(trajectory):
    """The trajectories exercise the path: mail is sent and routed every
    round after the first, and the hyparview run overflows a route cap."""
    model, trail = trajectory
    sent = [t[3]["mail_sent"] for t in trail]
    done = [t[3]["mail_processed"] for t in trail]
    assert min(sent) > 0 and min(done[1:]) > 0 and done[0] == 0
    if model == "hyparview":
        assert sum(t[3]["mail_dropped"] for t in trail) > 0
        assert int(trail[-1][2].dropped.sum()) == \
            sum(t[3]["mail_dropped"] for t in trail)


def test_health_through_to_dense_matches(trajectory):
    """hyparview/plumtree: connectivity of the last round's overlay;
    scamp (no readback ported): the partial views have filled."""
    model, trail = trajectory
    a, _, b, _, _ = trail[-1]
    if model == "scamp":
        assert (b.partial >= 0).sum(1).mean() > 2
        return
    a_hv = a.hv if model == "plumtree" else a
    b_hv = dd.state_from_numpy(b, device="cpu")
    b_hv = b_hv.hv if model == "plumtree" else b_hv
    want = {k: float(np.asarray(v))
            for k, v in ref_health(ref.to_dense(a_hv)).items()}
    got = {k: float(v) for k, v in connectivity(dd.to_dense(b_hv)).items()}
    assert want == got


@pytest.mark.parametrize("model", list(MODELS))
def test_init_matches(model):
    cfg_kw = MODELS[model][0]
    init = INITS[model]
    want = getattr(ref, init)(pt.Config(**cfg_kw), D)
    assert_same(want, getattr(dd, init)(Config(**cfg_kw), D, device="cpu"))


def test_staggered_cadence_matches():
    """Two blocks of the k=5 staggered cadence on the default cadence
    (shuffle 10, promotion 5): 20 rounds, one exchange each."""
    rcfg, cfg = pt.Config(n_nodes=N), Config(n_nodes=N)
    rm, pm = ref_mesh(n_devices=D), port_mesh.make_mesh(D, "cpu")
    want = ref.run_sharded_staggered(
        rcfg, rm, ref.place_sharded(ref.sharded_dense_init(rcfg, D), rm), 2,
        model="hyparview", k=5)
    before = port_mesh.ALL_TO_ALL
    got = dd.run_sharded_staggered(cfg, pm, dd.sharded_dense_init(
        cfg, D, device="cpu"), 2, model="hyparview", k=5)
    assert port_mesh.ALL_TO_ALL - before == 20
    assert int(got.rnd) == 20
    assert_same(want, got, "staggered")


def test_staggered_refuses_a_hotter_cadence_as_the_reference_does():
    with pytest.raises(AssertionError, match="stagger coarser"):
        ref.run_sharded_staggered(pt.Config(**HV), ref_mesh(n_devices=D),
                                  ref.sharded_dense_init(pt.Config(**HV), D),
                                  1, k=5)
    cfg = Config(**HV)
    with pytest.raises(ValueError, match="stagger coarser"):
        dd.run_sharded_staggered(cfg, port_mesh.make_mesh(D, "cpu"),
                                 dd.sharded_dense_init(cfg, D, device="cpu"),
                                 1, k=5)


def test_scamp_staggered_k1_is_the_flat_program():
    cfg = Config(n_nodes=N)
    pm = port_mesh.make_mesh(D, "cpu")
    st0 = dd.sharded_scamp_init(cfg, D, device="cpu")
    flat = dd.run_sharded(dd.make_sharded_dense_round(cfg, pm, model="scamp"),
                          st0, 12)
    stag = dd.run_sharded_staggered(cfg, pm, st0, 12, model="scamp", k=1)
    assert_same(dd.state_to_numpy(flat), stag)


def test_runners_equal_stepping():
    cfg = Config(**HV)
    step = dd.make_sharded_dense_round(cfg, port_mesh.make_mesh(D, "cpu"),
                                       churn=0.02)
    st = dd.sharded_dense_init(cfg, D, device="cpu")
    one = st
    for _ in range(7):
        one, _ = step(one)
    assert_same(dd.state_to_numpy(one), dd.run_sharded(step, st, 7))
    assert_same(dd.state_to_numpy(one),
                dd.run_sharded_chunked(step, dd.run_sharded(step, st, 3), 4,
                                       cfg))


def test_counters_are_summed_over_the_shards():
    cfg = Config(**HV)
    ctr = {"active_edges": lambda p: (p["active"] >= 0).sum(),
           "shard_rows": lambda p: p["alive"].shape[0]}
    step = dd.make_sharded_dense_round(cfg, port_mesh.make_mesh(D, "cpu"),
                                       counters=ctr)
    st = dd.sharded_dense_init(cfg, D, device="cpu")
    for _ in range(12):
        st, m = step(st)
    assert int(m["active_edges"]) == int((st.active >= 0).sum())
    assert int(m["shard_rows"]) == N


def test_carry_across_round_trips():
    _, a, _, b = make("plumtree")
    back = dd.state_to_numpy(dd.state_from_numpy(a, device="cpu"))
    assert_same(a, back)
    assert back.hv.rnd.dtype == np.int32 and back.hv.alive.dtype == np.bool_
    assert_same(back, dd.state_from_numpy(dd.state_to_numpy(b),
                                          device="cpu"))


@pytest.mark.parametrize("kw,match", [
    (dict(flight=object()), "flight= is not ported"),
    (dict(chaos=object()), "chaos= is not ported"),
    (dict(control=object()), "control= is not ported"),
    (dict(skip=frozenset({"gossip"})), "unknown phase"),
    (dict(model="scamp", skip=frozenset({"merge"})), "unknown phase"),
    (dict(model="xbot"), "unknown model")])
def test_named_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        dd.make_sharded_dense_round(Config(**HV),
                                    port_mesh.make_mesh(D, "cpu"), **kw)


def test_interpose_raises_the_reference_error():
    with pytest.raises(ValueError, match="interpose") as want:
        ref.make_sharded_dense_round(pt.Config(**HV), ref_mesh(n_devices=D),
                                     interpose=lambda *a: None)
    with pytest.raises(ValueError, match="interpose") as got:
        dd.make_sharded_dense_round(Config(**HV),
                                    port_mesh.make_mesh(D, "cpu"),
                                    interpose=lambda *a: None)
    assert str(got.value) == str(want.value)


def test_shards_must_split_the_nodes():
    with pytest.raises(ValueError, match="does not split"):
        dd.sharded_dense_init(Config(n_nodes=100), 8, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        dd.make_sharded_dense_round(Config(n_nodes=100),
                                    port_mesh.make_mesh(8, "cpu"))
    with pytest.raises(ValueError, match="n_shards >= 1"):
        port_mesh.make_mesh(0, "cpu")
