"""The dense rounds' routing primitives — the part of
``partisan_tpu/ops/shard_exchange.py`` that one card needs.

``reverse_select`` is the proposal router of the dense membership rounds:
node i proposes to ``targets[i]`` (-1 = none) and each target learns up to
``c`` proposers, ties broken by a salted hash.  It keeps the reference's
contract and its named guard, and runs through ``ops.route_kernel``: the
K1 CUDA kernel for a CUDA tensor, its plain PyTorch version for a CPU
tensor.  ``take_rows`` / ``take_vals`` are the padded gathers.

``bucket_exchange`` and ``route_select`` belong to the sharded dense
dataplane and are not ported yet.
"""

from __future__ import annotations

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


def take_rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mat[idx]`` rows with ``idx < 0`` yielding an all -1 row."""
    r = mat.shape[0]
    rows = mat[idx.clamp(0, r - 1).long()]
    return torch.where((idx >= 0).unsqueeze(-1), rows, -1)


def take_vals(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vec[idx]`` with ``idx < 0`` yielding -1."""
    r = vec.shape[0]
    return torch.where(idx >= 0, vec[idx.clamp(0, r - 1).long()], -1)
