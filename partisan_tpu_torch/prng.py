"""The ``jax.random`` subset this package needs, bit-exact with jax 0.9.0
under ``jax_threefry_partitionable=True`` and 32-bit mode, plus the
per-node key discipline of ``partisan_tpu/prng.py``.

Keys are int64 tensors of shape ``[..., 2]`` holding the two uint32 words
(torch has no usable uint32 arithmetic); every function takes a leading
batch of keys, so a whole run's per-round draws are one vectorised pass.
Work happens on the keys' device.  No global torch RNG is touched.

One key held on the CPU (shape ``[2]``) is hashed with its words as
Python ints: ``fold_in``, ``split`` and ``bits`` of it cost microseconds
instead of a chain of scalar tensor ops, and ``bits``, ``randint`` and
``uniform`` with a ``device`` draw there with the words as scalars, so
no key is copied to the card.  The dense rounds derive their per-round
keys this way and never wait on the card for them.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m mod 2^32`` for uint32 values without overflowing int64."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    of uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` in 32-bit mode: ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _host_words(key: torch.Tensor):
    """The two words of one key held on the CPU as Python ints; None for
    a batch of keys or a key on another device."""
    if key.dim() == 1 and key.device.type == "cpu":
        return key.tolist()
    return None


def _key(words) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int64)


def _hash_counts(key: torch.Tensor, counts: torch.Tensor):
    """threefry(key, (0, counts)) with key ``[..., 2]`` and counts of any
    trailing shape: outputs have shape ``[..., *counts.shape]``.  The
    counts' device is the draw's."""
    words = _host_words(key)
    if words is not None:
        k1, k2 = words
    else:
        view = key.shape[:-1] + (1,) * counts.dim()
        k1 = key[..., 0].reshape(view)
        k2 = key[..., 1].reshape(view)
    return threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` broadcasts against the key batch."""
    words = _host_words(key)
    if words is not None and isinstance(data, int):
        return _key(threefry2x32(*words, 0, data & MASK))
    data = _u32(data).to(key.device)
    k1, k2 = key[..., 0], key[..., 1]
    a, b = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like under partitionable threefry):
    ``[..., 2] -> [..., num, 2]``."""
    words = _host_words(key)
    if words is not None:
        return _key([threefry2x32(*words, 0, i) for i in range(num)])
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = _hash_counts(key, counts)
    return torch.stack((a, b), dim=-1)


def bits(key: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32): ``[..., 2] -> [..., *shape]``, drawn on ``device`` (by
    default the key's)."""
    shape = tuple(shape)
    device = key.device if device is None else torch.device(device)
    words = _host_words(key)
    if words is not None and not shape and device.type == "cpu":
        a, b = threefry2x32(*words, 0, 0)
        return _key(a ^ b)
    size = 1
    for s in shape:
        size *= s
    counts = torch.arange(size, dtype=torch.int64,
                          device=device).reshape(shape)
    a, b = _hash_counts(key, counts)
    return a ^ b


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32, as jax 0.9.0's ``_uniform``
    computes it: the top 23 bits of ``bits`` under the exponent of 1.0,
    bit-cast to float32, minus 1, scaled to ``[minval, maxval)`` and
    floored at ``minval``.  The bit-cast is an int32 ``view``, so exact.
    XLA contracts the scale and shift into one fused multiply-add, so
    they run in float64 (the float32 product is exact there) and round
    to float32 once; on [0, 1), the churn draw, both steps are exact.
    The float32 bounds are worked out on the CPU: a tensor built on the
    card from a Python number would wait for the card's stream."""
    raw = bits(key, shape, device)
    f = ((raw >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    scaled = (f - 1.0).double() * span + float(lo)
    return scaled.float().clamp_min(float(lo))


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` with int32 output, line for line after
    ``jax._src.random._randint``: two bit streams from ``split(key)``,
    reduced modulo the span with a ``2^32 mod span`` multiplier, in
    wrapping uint32 arithmetic, drawn on ``device`` (by default the
    key's)."""
    shape = tuple(shape)
    assert -2 ** 31 <= minval and maxval <= 2 ** 31 - 1
    keys = split(key, 2)
    higher = bits(keys[..., 0, :], shape, device)
    lower = bits(keys[..., 1, :], shape, device)
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = _mul32(higher % span, multiplier) + (lower % span)
    offset = (offset & MASK) % span
    return (minval + offset).to(torch.int32)


# ---- per-node key discipline (partisan_tpu/prng.py) ----------------------

def node_keys(seed: int, n_nodes: int, device=None) -> torch.Tensor:
    """[N, 2] — one independent key per virtual node."""
    return split(PRNGKey(seed, device), n_nodes)


def round_key(key: torch.Tensor, rnd) -> torch.Tensor:
    """Fold the round counter into a per-node key."""
    return fold_in(key, rnd)


def decision_key(key: torch.Tensor, slot: int) -> torch.Tensor:
    """Distinct stream per decision site within one node-round."""
    return fold_in(key, slot)
