"""Packed node bitsets — the counterpart of ``partisan_tpu/ops/bitset.py``.

Bit j of word w is node ``32*w + j``.  torch on the CPU has no shifts or
comparisons for ``uint32``, so words are carried as ``torch.int32``
holding the same 32 bits: multiplies wrap in two's complement exactly as
uint32 ones do, and a logical right shift is an arithmetic shift with the
sign-extended high bits masked off (``lshr``).  Compare with the reference
through ``numpy.view(np.uint32)``.
"""

from __future__ import annotations

import torch

from .. import prng

WORD = 32
_GOLDEN = 0x9E3779B9
_KNUTH = 2654435761


def i32(c: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= 1 << 31 else c


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor with the same low 32 bits."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def lshr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-carried uint32 words, 0 <= k < 32."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (32 - k)) - 1)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The package's splitmix-style 32-bit finalizer (same constants as
    ``partisan_tpu/ops/bitset.py:mix32``) on int32 words."""
    x = (x ^ lshr(x, 16)) * i32(0x7FEB352D)
    x = (x ^ lshr(x, 15)) * i32(0x846CA68B)
    return x ^ lshr(x, 16)


def less_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """Unsigned ``a < b`` for int32-carried words and a uint32 bound:
    flipping the sign bit of both maps unsigned order onto signed."""
    return (a ^ i32(0x80000000)) < i32(b ^ 0x80000000)


def n_words(n: int) -> int:
    return (n + WORD - 1) // WORD


def count(bs: torch.Tensor) -> int:
    """Number of set bits."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=bs.device)
    return int(((bs.unsqueeze(-1) >> shifts) & 1).sum())


def to_mask(bs: torch.Tensor, n: int) -> torch.Tensor:
    """[n] bool — unpack."""
    idx = torch.arange(n, device=bs.device)
    return ((bs[idx // WORD] >> (idx % WORD).to(torch.int32)) & 1) == 1


def from_mask(mask: torch.Tensor) -> torch.Tensor:
    """[n] bool -> [ceil(n/32)] int32 words."""
    n = mask.shape[0]
    w = n_words(n)
    pad = torch.zeros(w * WORD, dtype=torch.int64, device=mask.device)
    pad[:n] = mask.to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=mask.device)
    return wrap_i32((pad.reshape(w, WORD) << shifts).sum(dim=1))


def roll_bits(bs: torch.Tensor, s, n: int) -> torch.Tensor:
    """Circular bit-roll of an n-bit set: bit j of the result is bit
    (j - s) mod n of the input.  Requires ``n % WORD == 0``.  One word-roll
    plus a carry from the neighbouring word; ``r == 0`` takes the rolled
    word as it is, since the carry shift would be a full word."""
    assert n % WORD == 0 and bs.shape[0] == n // WORD
    s = int(s) % n
    q, r = divmod(s, WORD)
    xw = torch.roll(bs, q)
    if r == 0:
        return xw
    prev = torch.roll(bs, q + 1)
    return (xw << r) | lshr(prev, WORD - r)


def expansion(p: float, rel_err: float = 0.005, max_depth: int = 20):
    """The binary expansion of p that ``bernoulli_expand`` walks: depth D
    (``2^-D <= p * rel_err``, capped at ``max_depth``) and a mask whose
    bit ``d-1`` is p's bit at depth d.  The CUDA kernels take these two
    integers, so the host and the card walk the same expansion."""
    D = 1
    while 2.0 ** -D > p * rel_err and D < max_depth:
        D += 1
    ones = 0
    frac = p
    for d in range(1, D + 1):
        frac *= 2.0
        if frac >= 1.0:
            frac -= 1.0
            ones |= 1 << (d - 1)
    return D, ones


def bernoulli_expand(draw, p: float, rel_err: float = 0.005,
                     max_depth: int = 20) -> torch.Tensor:
    """The bit-serial ``u < p`` comparison: ``draw(d)`` supplies the words
    of uniform bits for depth d; ``eq`` tracks lanes whose u-prefix still
    equals p's prefix."""
    D, ones = expansion(p, rel_err, max_depth)
    eq = out = None
    for d in range(1, D + 1):
        u = draw(d)
        if eq is None:
            eq = torch.full_like(u, -1)
            out = torch.zeros_like(u)
        if ones >> (d - 1) & 1:
            out = out | (eq & ~u)
            eq = eq & u
        else:
            eq = eq & ~u
    return out


def biased_words(salt: int, p: float, w: int, device=None) -> torch.Tensor:
    """[w] int32 words of the salted packed Bernoulli(p) mask:
    ``draw(d) = mix32(word * 2654435761 ^ salt ^ d * 0x9E3779B9)``, the
    generator of the reference's ``biased_bits`` with its salt given."""
    assert 0.0 < p < 1.0
    idx = torch.arange(w, dtype=torch.int64, device=device)
    iota = wrap_i32(idx * _KNUTH)
    salt = i32(salt)
    draw = lambda d: mix32(iota ^ salt ^ i32(d * _GOLDEN))
    return bernoulli_expand(draw, p)


def biased_bits(key: torch.Tensor, p: float, w: int) -> torch.Tensor:
    """[w] int32 of (approximately) independent Bernoulli(p) bits, salted
    by ``prng.bits(key)`` — the reference's ``biased_bits``."""
    salt = int(prng.bits(key))
    return biased_words(salt, p, w, device=key.device)
