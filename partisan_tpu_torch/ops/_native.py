"""Build and bind the package's CUDA kernels.

The sources under ``partisan_tpu_torch/csrc/`` are compiled with ``nvcc``
for ``sm_90a`` at first use, one ``nvcc -c`` per source, all started
together, then linked into one shared library with a plain C interface
and loaded with ``ctypes``.  The library lands in
``build/partisan_tpu_torch/<hash of the sources>/`` at the root of the
checkout, so an edited source builds anew and an unchanged one is reused.
Every C entry returns the ``cudaError_t`` of its launch; ``check`` raises
on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("rumor_fused.cu", "rumor_hbm.cu", "route_select.cu",
           "bucket_pack.cu")
HEADERS = ("rumor_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
SIGNATURES = {
    # table, n_rounds, fanout, n, coin D/ones, churn D/ones, alive, inf,
    # hot, counts, stream
    "rumor_fused_run": (_P, _I, _I, _I, _I, _U, _I, _U, _P, _P, _P, _P, _P),
    # n_rounds, n, fanout, counts, stream
    "rumor_barrier_run": (_I, _I, _I, _P, _P),
    # table, n_rounds, fanout, rows, all_alive, coin D/ones, churn D/ones,
    # alive, inf, hot, counts, stream
    "rumor_hbm_run": (_P, _I, _I, _I, _I, _I, _U, _I, _U, _P, _P, _P, _P,
                      _P),
    # n_rounds, n, counts, stream
    "rumor_hbm_barrier_run": (_I, _I, _P, _P),
    # targets, salt, m, n, c, bits, scratch, out, stream
    "route_select_run": (_P, _U, _I, _I, _I, _I, _P, _P, _P),
    # shard, n_sh, m, d, b, counts, bstart, tgt, order, dropped, stream
    "bucket_pack_run": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
}

_lib = None
BUILD = {"log": "", "path": None}   # the last build's compiler output


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, which needs the CUDA toolkit")


def build() -> Path:
    """Compile the sources (if this hash has no library yet) and return
    the library's path.  Compiler output, including ``-Xptxas -v``'s
    registers and spills per kernel, goes to ``BUILD["log"]``."""
    out_dir = _PKG.parent / "build" / "partisan_tpu_torch" / _digest()
    lib_path = out_dir / "libpartisan_kernels.so"
    if lib_path.exists():
        BUILD["path"] = lib_path
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for src in SOURCES:
        obj = tmp / (src + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"--- {src}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        BUILD["log"] = "\n".join(logs)
        raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD['log']}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / lib_path.name),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs.append(f"--- link\n{link.stdout}")
    BUILD["log"] = "\n".join(logs)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{BUILD['log']}")
    os.replace(tmp / lib_path.name, lib_path)   # atomic: readers see all
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD["path"] = lib_path
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
