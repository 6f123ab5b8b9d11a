"""The port's CUDA kernels against their plain PyTorch versions.

This file imports only torch, numpy and the port, so it runs on the
machine with the card, which has no JAX reference stack:

    python -m pytest -m gpu tests/test_torch_kernels.py

The ``gpu`` tests skip here (no card); the others check, on the CPU, that
the wrappers run their plain versions for CPU tensors and count no
launch."""

import numpy as np
import pytest
import torch

from partisan_tpu_torch.models import demers
from partisan_tpu_torch.ops import bitset, rumor_kernel, rumor_kernel_hbm

CELL = 4096


def packed_world(n, seed, hot_frac=0.5, dead_frac=0.1, device="cpu"):
    rng = np.random.default_rng(seed)
    inf = rng.random(n) < 0.2
    masks = (inf, inf & (rng.random(n) < hot_frac),
             rng.random(n) >= dead_frac)
    words = [bitset.from_mask(torch.from_numpy(m)).to(device) for m in masks]
    return demers.RumorWorldPacked(
        *words, torch.tensor(seed, dtype=torch.int32, device=device))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run: pytest -m gpu)")
    return torch.device("cuda")


def test_cpu_tensors_run_the_plain_versions_without_launching():
    n = 2 * CELL
    w = packed_world(n, 1)
    before = (rumor_kernel.LAUNCHES, rumor_kernel_hbm.LAUNCHES)
    a = rumor_kernel.rumor_run_fused(w, 5, n, 2, 3, 0.01)
    b = rumor_kernel_hbm.rumor_run_hbm(w, 5, n, 2, 3, 0.01, 1, True)
    assert (rumor_kernel.LAUNCHES, rumor_kernel_hbm.LAUNCHES) == before
    for out in (a, b):
        assert out.infected.device.type == "cpu"
        assert int(out.rnd) == int(w.rnd) + 5
        assert torch.equal(out.alive, w.alive)


def test_hbm_plain_churn_reaches_the_endemic_window():
    """The counter-based churn generator keeps the epidemic's equilibrium:
    at 1% churn a run settles where the reference's does."""
    n = 4 * CELL
    w = demers.rumor_pack(demers.rumor_init(n, 3, device="cpu"))
    out = rumor_kernel_hbm.rumor_run_hbm(w, 400, n, 2, 1, 0.01, 1, True)
    assert 0.55 < bitset.count(out.infected) / n < 0.75


@pytest.mark.gpu
@pytest.mark.parametrize("churn", [0.0, 0.01])
@pytest.mark.parametrize("stop_k", [1, 3])
def test_fused_kernel_matches_plain(cuda, stop_k, churn):
    n = 4 * CELL
    for seed, hot_frac in ((1, 0.5), (2, 0.0)):
        w = packed_world(n, seed, hot_frac, device=cuda)
        table = rumor_kernel.rumor_table(int(w.rnd), 60, n, 2)
        want = rumor_kernel.rumor_run_fused_plain(w, table, n, stop_k, churn)
        got = rumor_kernel.rumor_run_fused_cuda(w, table, n, stop_k, churn)
        torch.cuda.synchronize()
        assert torch.equal(want.infected, got.infected)
        assert torch.equal(want.hot, got.hot)


@pytest.mark.gpu
def test_fused_main_path_equals_packed(cuda):
    """The headline entry point at full width: "fused" (one K3 launch)
    equals the packed scan; without churn the rumor covers ~98% of the
    nodes (0.9796 in the packed dynamics from patient zero 5)."""
    n = 1 << 20
    w = demers.rumor_init(n, 5, device=cuda)
    before = rumor_kernel.LAUNCHES
    out = demers.rumor_run(w, 300, n, 2, 1, 0.0, "fused")
    assert rumor_kernel.LAUNCHES == before + 1
    want = demers.rumor_run(w, 300, n, 2, 1, 0.0, "packed")
    assert torch.equal(out.infected, want.infected)
    assert torch.equal(out.hot, want.hot)
    assert float(out.infected.float().mean()) > 0.95


@pytest.mark.gpu
@pytest.mark.parametrize("churn", [0.0, 0.01])
@pytest.mark.parametrize("stop_k", [1, 3])
@pytest.mark.parametrize("all_alive", [False, True])
def test_hbm_kernel_matches_plain(cuda, all_alive, stop_k, churn):
    n = 8 * CELL
    for seed, hot_frac in ((1, 0.5), (2, 0.0)):
        w = packed_world(n, seed, hot_frac, device=cuda)
        table = rumor_kernel_hbm.hbm_table(int(w.rnd), 6, n, 2)
        want = rumor_kernel_hbm.rumor_run_hbm_plain(w, table, n, stop_k,
                                                    churn, all_alive)
        before = rumor_kernel_hbm.LAUNCHES
        got = rumor_kernel_hbm.rumor_run_hbm_cuda(w, table, n, stop_k, churn,
                                                  all_alive)
        torch.cuda.synchronize()
        assert rumor_kernel_hbm.LAUNCHES == before + 6
        assert torch.equal(want.infected, got.infected)
        assert torch.equal(want.hot, got.hot)
