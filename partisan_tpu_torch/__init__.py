"""partisan_tpu_torch — the PyTorch/CUDA port of ``partisan_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``partisan_tpu`` stays the reference; this package mirrors
its layout module for module and imports nothing of it (nor of JAX).
Slice 1 holds the Demers rumor-mongering path: ``prng`` (the ``jax.random``
threefry subset, bit-exact), ``ops.bitset`` (packed int32 words),
``models.demers`` (section 3, the rumor fast path) and the two hand-written
CUDA kernels behind ``ops.rumor_kernel`` (K3) and ``ops.rumor_kernel_hbm``
(K4).  Slice 2 holds the dense HyParView round: ``config`` (a copy of the
reference's), ``ops.padded_set`` (batched view sets),
``ops.shard_exchange.reverse_select`` over the K1 CUDA kernel behind
``ops.route_kernel``, ``models.dense_cadence`` and
``models.hyparview_dense``.

Entry points take ``device=None``, which means ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
