"""Guards of the port package: it imports neither JAX nor the reference,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "partisan_tpu")


def port_files():
    return sorted((ROOT / "partisan_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_reference():
    files = port_files()
    assert len(files) >= 10
    for path in files:
        bad = set(imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, partisan_tpu_torch.models.demers, "
            "partisan_tpu_torch.ops.rumor_kernel, "
            "partisan_tpu_torch.ops.rumor_kernel_hbm, "
            "partisan_tpu_torch.models.hyparview_dense, "
            "partisan_tpu_torch.parallel.dense_dataplane; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    from partisan_tpu_torch.models import demers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demers.rumor_init(4096)
    w = demers.rumor_init(4096, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demers.world_from_numpy(demers.world_to_numpy(w))
    assert demers.rumor_run(w, 2, 4096).infected.device.type == "cpu"


def test_dense_entry_points_raise_without_a_card(monkeypatch):
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.models import hyparview_dense as hd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(n_nodes=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hd.dense_init(cfg)
    s = hd.dense_init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hd.state_from_numpy(hd.state_to_numpy(s))
    assert hd.run_dense(s, 2, cfg).active.device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    from partisan_tpu_torch.models import demers
    from partisan_tpu_torch.ops import rumor_kernel, rumor_kernel_hbm
    w = demers.rumor_pack(demers.rumor_init(4096, device="cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rumor_kernel.rumor_run_fused_cuda(
            w, rumor_kernel.rumor_table(0, 1, 4096, 2), 4096, 1, 0.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rumor_kernel_hbm.rumor_run_hbm_cuda(
            w, rumor_kernel_hbm.hbm_table(0, 1, 4096, 2), 4096)


@pytest.mark.parametrize("bad", ["int64", "flat", "width"])
@pytest.mark.parametrize("kernel", ["fused", "hbm"])
def test_kernel_wrappers_refuse_a_misshapen_table(kernel, bad):
    """The kernels read the drawn table through a raw pointer: a table of
    another dtype, rank or width raises before any launch."""
    from partisan_tpu_torch.models import demers
    from partisan_tpu_torch.ops import rumor_kernel, rumor_kernel_hbm
    w = demers.rumor_pack(demers.rumor_init(4096, device="cpu"))
    if kernel == "fused":
        run, table = (rumor_kernel.rumor_run_fused_cuda,
                      rumor_kernel.rumor_table(0, 3, 4096, 2))
    else:
        run, table = (rumor_kernel_hbm.rumor_run_hbm_cuda,
                      rumor_kernel_hbm.hbm_table(0, 3, 4096, 2))
    table = {"int64": table.long(), "flat": table.reshape(-1),
             "width": table[:, :3]}[bad]
    before = (rumor_kernel.LAUNCHES, rumor_kernel_hbm.LAUNCHES)
    with pytest.raises(ValueError, match="table: want int32"):
        run(w, table, 4096, 1, 0.0)
    assert (rumor_kernel.LAUNCHES, rumor_kernel_hbm.LAUNCHES) == before


def test_sharded_entry_points_raise_without_a_card(monkeypatch):
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.parallel import dense_dataplane as dd
    from partisan_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(n_nodes=64)
    for fn in (lambda: mesh.make_mesh(8),
               lambda: dd.sharded_dense_init(cfg, 8),
               lambda: dd.sharded_pt_init(cfg, 8),
               lambda: dd.sharded_scamp_init(cfg, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    s = dd.sharded_dense_init(cfg, 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dd.state_from_numpy(dd.state_to_numpy(s))
    step = dd.make_sharded_dense_round(cfg, mesh.make_mesh(8, "cpu"))
    assert dd.run_sharded(step, s, 2).active.device.type == "cpu"
