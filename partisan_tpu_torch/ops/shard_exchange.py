"""The dense rounds' routing primitives — the counterpart of
``partisan_tpu/ops/shard_exchange.py``.

``reverse_select`` is the proposal router of the dense membership rounds:
node i proposes to ``targets[i]`` (-1 = none) and each target learns up to
``c`` proposers, ties broken by a salted hash.  It keeps the reference's
contract and its named guard, and runs through ``ops.route_kernel``: the
K1 CUDA kernel for a CUDA tensor, its plain PyTorch version for a CPU
tensor.  ``take_rows`` / ``take_vals`` are the padded gathers.

The sharded dense dataplane adds two pieces, over virtual shards (the
shard is a leading dimension of one device's tensors, ``parallel/mesh.py``):

  bucket_exchange   every shard's mail matrix bucketed by destination
                    shard (K2, ``route_kernel.bucket_pack_kernel``: a
                    stable rank, head-cap overflow counted), scattered into
                    ``[D, D, B, C]`` buckets and moved by the mesh's ONE
                    all-to-all;
  route_select      one ``reverse_select`` a shard over the combined
                    (kind, local destination) key space routes a whole
                    received mailbox to per-(kind, node) slots.

No imports from parallel/ or models/ (this sits below both): the exchange
takes the mesh as an argument and calls its ``all_to_all``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import route_kernel


def reverse_select(targets: torch.Tensor, salt: int, n: int, c: int
                   ) -> torch.Tensor:
    """Route per-node proposals to their targets without scatter
    conflicts.  ``targets`` is ``[m]`` int32, ``salt`` a uint32 as a
    Python int; returns ``[n, c]`` int32 proposer ids (-1 pad), bit-exact
    with the reference's ``reverse_select``; raises the reference's named
    ValueError for n >= 2^27."""
    return route_kernel.reverse_select_kernel(targets, salt, n, c)


def default_bucket_cap(out_rows: int, n_shards: int) -> int:
    """Per-(sender, receiver) bucket cap: 2x the uniform share of the
    sender's outbox, floored at 16 (the reference's rule: overflow is
    counted, and 2x the mean keeps it negligible)."""
    return max(16, -(-2 * out_rows // n_shards))


def bucket_exchange(mail: torch.Tensor, n_loc: int, n_shards: int,
                    bucket_cap: int, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move every shard's mail matrix to its destination shards in ONE
    ``mesh.all_to_all``.  ``mail`` is ``[D, M, C]`` int32, shard k's
    outbox at ``mail[k]``, column 0 the valid flag and column 1 the GLOBAL
    destination node id; rows bucket by ``dst // n_loc``.

    Returns ``(recv [D, D * B, C], dropped [D])``: shard k's ``recv`` is
    sender-shard-major (sender j's bucket at rows ``[j*B, (j+1)*B)``),
    empty slots all-zero; ``dropped`` counts each sender's rows head-capped
    out of a full bucket.  Bit-exact with the reference's
    ``bucket_exchange`` run inside ``shard_map`` on each shard."""
    n_sh, m, cols = mail.shape
    d, b = n_shards, bucket_cap
    dev = mail.device
    valid = mail[..., 0] != 0
    shard = torch.where(valid, mail[..., 1].clamp(0, d * n_loc - 1) // n_loc,
                        d).to(torch.int32)
    tgt, order, dropped = route_kernel.bucket_pack_kernel(shard, d, b)
    base = torch.arange(n_sh, dtype=torch.int64, device=dev)[:, None]
    rows = mail.reshape(n_sh * m, cols)[(order + base * m).reshape(-1)]
    buck = torch.zeros((n_sh, d * b + 1, cols), dtype=mail.dtype, device=dev)
    # tgt is unique but for the dump slot d*b, which is cut off below
    buck.view(-1, cols).index_copy_(
        0, (tgt + base * (d * b + 1)).reshape(-1), rows)
    recv = mesh.all_to_all(buck[:, : d * b].reshape(n_sh, d, b, cols))
    return recv.reshape(n_sh, d * b, cols), dropped


def route_select(kind: torch.Tensor, dst_local: torch.Tensor,
                 valid: torch.Tensor, n_kinds: int, n_loc: int, cap: int,
                 salt: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route received mailboxes to per-(kind, local node) slots with one
    ``reverse_select`` each over the key space ``kind * n_loc +
    dst_local``.  The inputs are one shard's ``[m]`` rows or a stack
    ``[D, m]`` of every shard's; returns ``(sel [..., n_kinds, n_loc,
    cap], dropped [...])``: ``sel`` holds row indices into each shard's
    mailbox (-1 pad), ``dropped`` the valid rows that landed no slot."""
    tgt = torch.where(valid & (kind >= 0) & (kind < n_kinds),
                      kind * n_loc + dst_local, -1).to(torch.int32)
    lead = tgt.shape[:-1]
    sel = torch.stack([
        reverse_select(t.contiguous(), salt, n_kinds * n_loc, cap)
        for t in tgt.reshape(-1, tgt.shape[-1])])
    sel = sel.reshape(*lead, n_kinds, n_loc, cap)
    dropped = valid.sum(-1) - (sel >= 0).flatten(-3).sum(-1)
    return sel, dropped.to(torch.int32)


def take_rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mat[idx]`` rows with ``idx < 0`` yielding an all -1 row."""
    r = mat.shape[0]
    rows = mat[idx.clamp(0, r - 1).long()]
    return torch.where((idx >= 0).unsqueeze(-1), rows, -1)


def take_vals(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vec[idx]`` with ``idx < 0`` yielding -1."""
    r = vec.shape[0]
    return torch.where(idx >= 0, vec[idx.clamp(0, r - 1).long()], -1)
