"""The dense rounds' two routing kernels — the counterparts of
``partisan_tpu/ops/route_kernel.py``.

K1, ``reverse_select_kernel(targets, salt, n, c)``, is the proposal
router.  It checks its arguments, then launches ``csrc/route_select.cu``
for a CUDA tensor (``reverse_select_cuda``) or runs the plain PyTorch
version for a CPU tensor (``reverse_select_plain``); there is no fallback
from one to the other.  Both compute ``shard_exchange.reverse_select`` of
the reference bit for bit: the kernel sorts the unique 64-bit composite
key ``(packed << 32 | i)``, whose ascending order is ``lax.sort``'s stable
order, and the plain version is a stable ``torch.sort`` of the packed key
with the reference's first-change + prefix-max rank.

K2, ``bucket_pack_kernel(shard, d, b)``, is the shard-local leg of the
sharded round's mail exchange: the stable rank of every mail row in its
destination-shard bucket.  The same rule holds: ``csrc/bucket_pack.cu``
(a stable counting sort, ``bucket_pack_cuda``) for a CUDA tensor, the
reference's stable sort and rank in torch ops (``bucket_pack_plain``) for
a CPU tensor.  It takes one outbox ``[m]`` or a stack of them ``[S, m]``,
which one call packs together.

``LAUNCHES`` counts calls of K1 and ``PACK_LAUNCHES`` calls of K2 (one per
call, after its launches were accepted); chip_smoke.py resets and reads
them.
"""

from __future__ import annotations

import torch

from . import _native
from .bitset import i32, mix32

MASK = 0xFFFFFFFF
MAX_M = 1 << 30      # the kernel pads m to a power of two held in an int
MAX_SHARD_ID = 255   # K2 keeps d + 1 bucket counts a warp in shared memory
MAX_OUTBOXES = 65535  # K2's outboxes are its grid's y dimension
BUCKET_CHUNK = 256   # rows a warp of K2 ranks (CHUNK in bucket_pack.cu)

LAUNCHES = 0
PACK_LAUNCHES = 0


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


# ------------------------------------------------------------ K2 bucket pack

def check_bucket_args(shard: torch.Tensor, d: int, b: int) -> None:
    """K2's contract: a contiguous int32 ``[m]`` or ``[S, m]`` of shard ids
    in ``[0, d]`` (d = invalid row), 1 <= m <= 2^30, 1 <= S <= 65535,
    1 <= d <= 255, b >= 1 and d * b < 2^31.  Ids outside ``[0, d]`` are
    outside the contract; both versions read them as d."""
    if (not isinstance(shard, torch.Tensor) or shard.dtype != torch.int32
            or shard.dim() not in (1, 2) or not shard.is_contiguous()):
        raise ValueError("shard: want a contiguous [m] or [S, m] int32 "
                         "tensor, got "
                         f"{getattr(shard, 'dtype', type(shard))} "
                         f"{tuple(getattr(shard, 'shape', ()))}")
    if not 1 <= shard.shape[-1] <= MAX_M:
        raise ValueError(f"shard: want 1 <= m <= 2^30 rows, got "
                         f"{shard.shape[-1]}")
    if shard.dim() == 2 and not 1 <= shard.shape[0] <= MAX_OUTBOXES:
        raise ValueError(f"shard: want 1 <= S <= {MAX_OUTBOXES} outboxes, "
                         f"got {shard.shape[0]}")
    if not 1 <= d <= MAX_SHARD_ID or b < 1:
        raise ValueError(f"bucket_pack: want 1 <= d <= {MAX_SHARD_ID} and "
                         f"b >= 1, got d={d}, b={b}")
    if d * b >= (1 << 31):
        raise ValueError(f"bucket_pack: d*b = {d * b} slots do not fit "
                         f"int32 offsets")


def bucket_pack_plain(shard: torch.Tensor, d: int, b: int):
    """The plain version: ``shard_exchange.py:147-154`` of the reference
    in torch ops, batched over leading outboxes, on the tensor's device."""
    dev = shard.device
    m = shard.shape[-1]
    key = torch.where((shard >= 0) & (shard <= d), shard, d)
    sk, order = torch.sort(key, dim=-1, stable=True)
    buckets = torch.arange(d, dtype=sk.dtype, device=dev)
    starts = torch.searchsorted(
        sk, buckets.expand(*sk.shape[:-1], d).contiguous())
    pos = (torch.arange(m, device=dev)
           - torch.gather(starts, -1, sk.clamp(0, d - 1).long()))
    ok = (sk < d) & (pos < b)
    dropped = ((sk < d) & ~ok).sum(-1, dtype=torch.int32)
    tgt = torch.where(ok, sk.long() * b + pos.clamp(0, b - 1), d * b)
    return tgt.to(torch.int32), order.to(torch.int32), dropped


def bucket_pack_cuda(shard: torch.Tensor, d: int, b: int):
    """One call of ``csrc/bucket_pack.cu`` (histogram, scan, scatter) over
    every outbox of ``shard``."""
    global PACK_LAUNCHES
    check_bucket_args(shard, d, b)
    dev = shard.device
    if dev.type != "cuda":
        raise ValueError(f"the K2 kernel runs on a CUDA tensor, got {dev}")
    m = shard.shape[-1]
    n_sh = shard.numel() // m
    chunks = -(-m // BUCKET_CHUNK)
    counts = torch.empty(n_sh * (d + 1) * chunks, dtype=torch.int32,
                         device=dev)
    bstart = torch.empty(n_sh * (d + 2), dtype=torch.int32, device=dev)
    tgt = torch.empty_like(shard)
    order = torch.empty_like(shard)
    dropped = torch.empty(shard.shape[:-1], dtype=torch.int32, device=dev)
    err = _native.lib().bucket_pack_run(
        shard.data_ptr(), n_sh, m, d, b, counts.data_ptr(),
        bstart.data_ptr(), tgt.data_ptr(), order.data_ptr(),
        dropped.data_ptr(), _native.stream_handle(shard))
    _native.check(err, "bucket_pack_run")
    PACK_LAUNCHES += 1
    return tgt, order, dropped


def bucket_pack_kernel(shard: torch.Tensor, d: int, b: int):
    """``(tgt, order, dropped)`` of every mail row's stable rank in its
    destination-shard bucket: ``tgt``/``order`` shaped as ``shard``
    (int32), ``dropped`` one int32 a leading outbox.  The kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    check_bucket_args(shard, d, b)
    if shard.is_cuda:
        return bucket_pack_cuda(shard, d, b)
    if shard.device.type != "cpu":
        raise ValueError(f"bucket_pack: no kernel for {shard.device}")
    return bucket_pack_plain(shard, d, b)
