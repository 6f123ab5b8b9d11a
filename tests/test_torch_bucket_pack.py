"""The port's mail exchange (partisan_tpu_torch/ops/shard_exchange.py
``bucket_exchange`` and ``route_select`` over virtual shards, and the plain
version of K2 in ops/route_kernel.py) against partisan_tpu/ops/
shard_exchange.py run inside ``shard_map`` on the 8-device CPU mesh, and
against the reference's Pallas ``bucket_pack_kernel`` in interpret mode.
Inputs come from a numpy seed; every comparison is exact.  The K2 CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from partisan_tpu.ops import shard_exchange as ref
from partisan_tpu.ops.route_kernel import bucket_pack_kernel
from partisan_tpu.parallel.mesh import NODE_AXIS, make_mesh as ref_mesh
from partisan_tpu_torch.ops import route_kernel, shard_exchange
from partisan_tpu_torch.parallel import mesh as port_mesh

COLS = 15


def shard_ids(m, d, seed, invalid=1 / 3):
    """[m] int32 in [0, d]: about ``invalid`` of the rows at d."""
    g = np.random.default_rng(seed)
    s = g.integers(0, d, m)
    return np.where(g.random(m) < invalid, d, s).astype(np.int32)


def mailbox(n_sh, m, n, seed, valid=2 / 3):
    """[n_sh, m, 15] int32 mail rows: valid flag, destination in [0, n),
    random payload columns."""
    g = np.random.default_rng(seed)
    mail = g.integers(-5, 1000, (n_sh, m, COLS)).astype(np.int32)
    mail[..., 0] = g.random((n_sh, m)) < valid
    mail[..., 1] = g.integers(0, n, (n_sh, m))
    return mail


def port_pack(s, d, b):
    return [x.numpy() for x in route_kernel.bucket_pack_plain(
        torch.from_numpy(s), d, b)]


@pytest.mark.parametrize("m,d,b,invalid", [
    (1, 1, 1, 0.0), (1, 8, 16, 1.0), (37, 2, 5, 0.3), (37, 8, 2, 0.3),
    (600, 8, 100, 1 / 3), (600, 1, 150, 0.5), (600, 8, 600, 1.0)])
def test_plain_matches_the_pallas_twin_in_interpret_mode(m, d, b, invalid):
    s = shard_ids(m, d, m * 7 + d, invalid)
    tgt, order, dropped = bucket_pack_kernel(jnp.asarray(s), d, b,
                                             interpret=True)
    got = port_pack(s, d, b)
    np.testing.assert_array_equal(np.asarray(tgt), got[0])
    np.testing.assert_array_equal(np.asarray(order), got[1])
    assert int(dropped) == int(got[2])


@pytest.mark.parametrize("m,d,b", [(1, 1, 16), (513, 2, 16), (4096, 8, 17),
                                   (4096, 8, 1024), (3001, 2, 600)])
def test_batched_plain_equals_one_outbox_at_a_time(m, d, b):
    """A stack of outboxes packs as each one alone; tight caps drop."""
    s = np.stack([shard_ids(m, d, m + i, 0.2) for i in range(3)])
    got = port_pack(s, d, b)
    for i in range(3):
        one = port_pack(s[i], d, b)
        for k in range(3):
            np.testing.assert_array_equal(got[k][i], one[k])
    counts = np.stack([np.bincount(r, minlength=d + 1)[:d] for r in s])
    np.testing.assert_array_equal(got[2], np.maximum(counts - b, 0).sum(1))


def _ref_exchange(d, n_loc, b):
    mesh = ref_mesh(n_devices=d)

    def body(mail):
        recv, drop = ref.bucket_exchange(mail, n_loc, d, b, NODE_AXIS)
        return recv, drop.reshape(1)
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(NODE_AXIS),),
                             out_specs=(P(NODE_AXIS), P(NODE_AXIS)),
                             check_rep=False))


@pytest.mark.parametrize("d,n_loc,m,b", [(8, 32, 96, 24), (8, 32, 96, 5),
                                         (2, 5, 33, 16), (1, 40, 17, 16),
                                         (8, 4, 1, 16)])
def test_bucket_exchange_matches_the_reference_in_shard_map(d, n_loc, m, b):
    mail = mailbox(d, m, d * n_loc, d * 1000 + m + b)
    want_recv, want_drop = _ref_exchange(d, n_loc, b)(
        jnp.asarray(mail.reshape(d * m, COLS)))
    before = port_mesh.ALL_TO_ALL
    recv, dropped = shard_exchange.bucket_exchange(
        torch.from_numpy(mail), n_loc, d, b, port_mesh.make_mesh(d, "cpu"))
    assert port_mesh.ALL_TO_ALL == before + 1
    np.testing.assert_array_equal(np.asarray(want_recv),
                                  recv.reshape(d * d * b, COLS).numpy())
    np.testing.assert_array_equal(np.asarray(want_drop), dropped.numpy())


def test_bucket_exchange_of_an_empty_outbox_is_all_zero():
    d, n_loc, b = 8, 16, 16
    mail = np.zeros((d, 40, COLS), np.int32)
    recv, dropped = shard_exchange.bucket_exchange(
        torch.from_numpy(mail), n_loc, d, b, port_mesh.make_mesh(d, "cpu"))
    assert recv.shape == (d, d * b, COLS)
    assert not recv.any() and not dropped.any()


@pytest.mark.parametrize("n_kinds,n_loc,cap,m", [(6, 32, 6, 400),
                                                 (3, 32, 2, 400),
                                                 (6, 4, 1, 9)])
def test_route_select_matches_the_reference_in_shard_map(n_kinds, n_loc, cap,
                                                         m):
    d = 8
    g = np.random.default_rng(n_kinds * 100 + cap)
    kind = g.integers(-1, n_kinds + 1, (d, m)).astype(np.int32)
    dstl = g.integers(0, n_loc, (d, m)).astype(np.int32)
    valid = g.random((d, m)) < 0.7
    salt = 0x9E3779B9

    def body(k, t, v):
        sel, drop = ref.route_select(k, t, v, n_kinds, n_loc, cap,
                                     jnp.uint32(salt))
        return sel[None], drop.reshape(1)
    fn = jax.jit(shard_map(body, mesh=ref_mesh(n_devices=d),
                           in_specs=(P(NODE_AXIS),) * 3,
                           out_specs=(P(NODE_AXIS), P(NODE_AXIS)),
                           check_rep=False))
    want_sel, want_drop = fn(*(jnp.asarray(x.reshape(-1))
                               for x in (kind, dstl, valid)))
    sel, dropped = shard_exchange.route_select(
        torch.from_numpy(kind), torch.from_numpy(dstl),
        torch.from_numpy(valid), n_kinds, n_loc, cap, salt)
    np.testing.assert_array_equal(np.asarray(want_sel), sel.numpy())
    np.testing.assert_array_equal(np.asarray(want_drop), dropped.numpy())
    one, one_drop = shard_exchange.route_select(
        torch.from_numpy(kind[3]), torch.from_numpy(dstl[3]),
        torch.from_numpy(valid[3]), n_kinds, n_loc, cap, salt)
    assert torch.equal(one, sel[3]) and int(one_drop) == int(dropped[3])


def test_default_bucket_cap_matches_the_reference():
    for rows, d in ((1, 1), (96, 8), (2359296, 8), (1000, 3), (7, 2)):
        assert shard_exchange.default_bucket_cap(rows, d) == \
            ref.default_bucket_cap(rows, d)


@pytest.mark.parametrize("bad", ["int64", "3d", "strided", "empty", "d0",
                                 "d_big", "b0", "slots"])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad):
    s = torch.zeros(8, dtype=torch.int32)
    d, b = 4, 2
    if bad == "int64":
        s = s.long()
    elif bad == "3d":
        s = s.reshape(2, 2, 2)
    elif bad == "strided":
        s = torch.zeros(16, dtype=torch.int32)[::2]
    elif bad == "empty":
        s = s[:0]
    elif bad == "d0":
        d = 0
    elif bad == "d_big":
        d = route_kernel.MAX_SHARD_ID + 1
    elif bad == "b0":
        b = 0
    else:
        d, b = 255, 1 << 24
    before = route_kernel.PACK_LAUNCHES
    for fn in (route_kernel.bucket_pack_kernel, route_kernel.bucket_pack_cuda):
        with pytest.raises(ValueError):
            fn(s, d, b)
    assert route_kernel.PACK_LAUNCHES == before


def test_cpu_tensors_run_the_plain_version_without_launching():
    s = torch.from_numpy(shard_ids(300, 8, 1))
    before = route_kernel.PACK_LAUNCHES
    got = route_kernel.bucket_pack_kernel(s, 8, 20)
    assert route_kernel.PACK_LAUNCHES == before
    for a, b in zip(got, route_kernel.bucket_pack_plain(s, 8, 20)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        route_kernel.bucket_pack_cuda(s, 8, 20)
    assert route_kernel.PACK_LAUNCHES == before
