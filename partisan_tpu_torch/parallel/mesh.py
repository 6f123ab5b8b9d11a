"""The node-axis mesh of the sharded rounds — the counterpart of
``partisan_tpu/parallel/mesh.py`` for one card.

The reference shards the node axis of a state over a ``jax.sharding.Mesh``
and runs the sharded rounds inside ``shard_map``; their cross-shard traffic
is one ``lax.all_to_all`` and one ``lax.psum`` a round.  Here every shard
lives on one device as a leading dimension of the same tensors (virtual
shards): :class:`VirtualMesh` carries the shard count and the device, and
its two collectives are tensor ops on that dimension.

- :meth:`VirtualMesh.all_to_all` takes ``[D_src, D_dst, ...]`` buckets and
  returns them ``[D_dst, D_src, ...]``: each receiving shard gets every
  sender's bucket for it, sender-major, as ``lax.all_to_all(split_axis=0,
  concat_axis=0)`` hands them over.
- :meth:`VirtualMesh.all_reduce` sums ``[D, ...]`` per-shard values over
  the shards, as ``psum`` does.

A transport over several cards (``torch.distributed`` all-to-all and
all-reduce on NCCL) takes the same two methods.  The reference asserts its
per-round collective budget by parsing the compiled HLO
(``collective_stats`` / ``assert_collective_budget``); here each method
adds one to a module count (``ALL_TO_ALL``, ``ALL_REDUCE``), so a test can
read how many collectives a round made.
"""

from __future__ import annotations

import torch

from .. import resolve_device

NODE_AXIS = "nodes"

ALL_TO_ALL = 0   # calls of VirtualMesh.all_to_all
ALL_REDUCE = 0   # calls of VirtualMesh.all_reduce


class VirtualMesh:
    """``n_shards`` shards of the node axis, all on ``device``."""

    def __init__(self, n_shards: int, device=None):
        if n_shards < 1:
            raise ValueError(f"make_mesh: want n_shards >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"VirtualMesh(n_shards={self.n_shards}, device={self.device})"

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        """``[D_src, D_dst, ...] -> [D_dst, D_src, ...]``."""
        global ALL_TO_ALL
        if buckets.shape[:2] != (self.n_shards, self.n_shards):
            raise ValueError(f"all_to_all: want [{self.n_shards}, "
                             f"{self.n_shards}, ...] buckets, got "
                             f"{tuple(buckets.shape)}")
        ALL_TO_ALL += 1
        return buckets.transpose(0, 1).contiguous()

    def all_reduce(self, vals: torch.Tensor) -> torch.Tensor:
        """Sum ``[D, ...]`` per-shard values over the shards."""
        global ALL_REDUCE
        if vals.shape[0] != self.n_shards:
            raise ValueError(f"all_reduce: want [{self.n_shards}, ...], got "
                             f"{tuple(vals.shape)}")
        ALL_REDUCE += 1
        return vals.sum(0, dtype=vals.dtype)


def make_mesh(n_shards: int, device=None) -> VirtualMesh:
    """The 1-D node-axis mesh: ``n_shards`` virtual shards on ``device``
    (None means the card)."""
    return VirtualMesh(n_shards, device)
