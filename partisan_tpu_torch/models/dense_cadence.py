"""The dense phase cadence — the counterpart of
``partisan_tpu/models/dense_cadence.py``.

One block is a list of ``(body, length)`` segments run in order, each body
a ``state -> state`` round program run ``length`` times: heavy programs
as length-1 segments, light programs as length-(k-1) runs.  The
reference scans the block with ``lax.scan``; PyTorch runs eagerly, so
here it is a Python loop.  A length-0 segment is skipped, so ``k=1``
cadences reduce exactly to the every-round program.

Exactness contract (asserted where each protocol builds its programs): a
heavy program's widened due window holds at most one nominal due round
per node per phase, so each node still acts once per interval, quantized
to the heavy grid.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple


def block_scan(segments: Sequence[Tuple[Callable, int]], carry,
               n_blocks: int):
    """Run ``n_blocks`` blocks; each block runs every (body, length)
    segment in order, ``length`` times."""
    for _ in range(n_blocks):
        for body, length in segments:
            for _ in range(length):
                carry = body(carry)
    return carry
