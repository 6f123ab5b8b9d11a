"""K1: the dense rounds' proposal router as a CUDA kernel — the counterpart
of ``partisan_tpu/ops/route_kernel.py::reverse_select_kernel``.

``reverse_select_kernel(targets, salt, n, c)`` checks its arguments, then
launches ``csrc/route_select.cu`` for a CUDA tensor
(``reverse_select_cuda``) or runs the plain PyTorch version for a CPU
tensor (``reverse_select_plain``); there is no fallback from one to the
other.  Both compute ``shard_exchange.reverse_select`` of the reference
bit for bit: the kernel sorts the unique 64-bit composite key
``(packed << 32 | i)``, whose ascending order is ``lax.sort``'s stable
order, and the plain version is a stable ``torch.sort`` of the packed key
with the reference's first-change + prefix-max rank.

``LAUNCHES`` counts calls of the kernel (one per call, after its launches
were accepted); chip_smoke.py resets and reads it.
"""

from __future__ import annotations

import torch

from . import _native
from .bitset import i32, mix32

MASK = 0xFFFFFFFF
MAX_M = 1 << 30      # the kernel pads m to a power of two held in an int

LAUNCHES = 0


def check_n(n: int) -> None:
    """The packed key carries the target id in its high bits: n < 2^27
    keeps at least 4 random tiebreak bits."""
    if n >= (1 << 27):
        raise ValueError(
            f"reverse_select: n={n} target ids do not fit the packed "
            f"single-key sort — the uint32 key carries the target id in "
            f"the high bits and needs n < 2^27 to keep >= 4 random "
            f"tiebreak bits; shard the index space (route_select / the "
            f"sharded dense round) instead of raising n")


def key_bits(n: int) -> int:
    """Random tiebreak bits under the target id: 31 - bitlen(n)."""
    return 31 - max(n.bit_length(), 1)


def pow2_above(m: int) -> int:
    return 1 << max(m - 1, 0).bit_length()


def check_args(targets: torch.Tensor, n: int, c: int) -> None:
    """The kernel's contract: contiguous 1-D int32 targets, 1 <= m <=
    2^30, 1 <= n < 2^27, c >= 1 and n * c < 2^31."""
    if (not isinstance(targets, torch.Tensor)
            or targets.dtype != torch.int32 or targets.dim() != 1
            or not targets.is_contiguous()):
        raise ValueError("targets: want a contiguous 1-D int32 tensor, got "
                         f"{getattr(targets, 'dtype', type(targets))} "
                         f"{tuple(getattr(targets, 'shape', ()))}")
    if not 1 <= targets.shape[0] <= MAX_M:
        raise ValueError(f"targets: want 1 <= m <= 2^30 rows, got "
                         f"{targets.shape[0]}")
    if c < 1 or n < 1:
        raise ValueError(f"reverse_select: want n >= 1 and c >= 1, got "
                         f"n={n}, c={c}")
    check_n(n)
    if n * c >= (1 << 31):
        raise ValueError(f"reverse_select: n*c = {n * c} slots do not fit "
                         f"int32 offsets")


def packed_keys(targets: torch.Tensor, salt: int, n: int) -> torch.Tensor:
    """[m] int64 sort keys ``sk << bits | mix32(i ^ salt) >> (32 - bits)``
    (uint32 values), ``sk`` the target or n for none."""
    bits = key_bits(n)
    valid = (targets >= 0) & (targets < n)
    sk = torch.where(valid, targets, n).long()
    i = torch.arange(targets.shape[0], dtype=torch.int32,
                     device=targets.device)
    r = mix32(i ^ i32(salt)).long() & MASK
    return (sk << bits) | (r >> (32 - bits))


def reverse_select_plain(targets: torch.Tensor, salt: int, n: int, c: int
                         ) -> torch.Tensor:
    """The plain version: ``shard_exchange.py:85-105`` of the reference
    in torch ops, on the tensor's device."""
    dev = targets.device
    m = targets.shape[0]
    sp, order = torch.sort(packed_keys(targets, salt, n), stable=True)
    st = sp >> key_bits(n)
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = st[1:] != st[:-1]
    idx = torch.arange(m, device=dev)
    pos = idx - torch.cummax(torch.where(first, idx, 0), dim=0).values
    ok = (st < n) & (pos < c)
    out = torch.full((n * c,), -1, dtype=torch.int32, device=dev)
    out[(st * c + pos)[ok]] = order[ok].to(torch.int32)
    return out.view(n, c)


def reverse_select_cuda(targets: torch.Tensor, salt: int, n: int, c: int
                        ) -> torch.Tensor:
    """One call of ``csrc/route_select.cu`` (pack, bitonic sort, emit)."""
    global LAUNCHES
    check_args(targets, n, c)
    dev = targets.device
    if dev.type != "cuda":
        raise ValueError(f"the K1 kernel runs on a CUDA tensor, got {dev}")
    m = targets.shape[0]
    scratch = torch.empty(pow2_above(m), dtype=torch.int64, device=dev)
    out = torch.empty((n, c), dtype=torch.int32, device=dev)
    err = _native.lib().route_select_run(
        targets.data_ptr(), int(salt) & MASK, m, n, c, key_bits(n),
        scratch.data_ptr(), out.data_ptr(), _native.stream_handle(out))
    _native.check(err, "route_select_run")
    LAUNCHES += 1
    return out


def reverse_select_kernel(targets: torch.Tensor, salt: int, n: int, c: int
                          ) -> torch.Tensor:
    """``[n, c]`` int32 proposer ids (-1 pad): the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    check_args(targets, n, c)
    if targets.is_cuda:
        return reverse_select_cuda(targets, salt, n, c)
    if targets.device.type != "cpu":
        raise ValueError(f"reverse_select: no kernel for {targets.device}")
    return reverse_select_plain(targets, salt, n, c)
