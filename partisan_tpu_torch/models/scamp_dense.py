"""Dense SCAMP — the part of ``partisan_tpu/models/scamp_dense.py`` that the
sharded SCAMP round needs: its view and walker caps.  The unsharded dense
SCAMP round is not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

from ..config import Config


def default_view_cap(n_nodes: int, c: int) -> int:
    """Partial-view capacity (``partisan_tpu/models/scamp.py``): SCAMP
    converges to ~(c+1)·ln N subscriptions per node; double it for
    headroom."""
    return max(16, int(2 * (c + 1) * math.log(max(n_nodes, 2))))


def walker_caps(cfg: Config) -> Tuple[int, int]:
    """(P, C): the view cap and the walker slots.  C
    (``cfg.scamp_walker_slots``) bounds ONE subject's concurrent walk
    copies; the join fan-out (one copy per contact view member + c
    extras) truncates to C, the excess counted (walk_truncated)."""
    return default_view_cap(cfg.n_nodes, cfg.scamp_c), \
        cfg.scamp_walker_slots
