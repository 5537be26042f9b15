"""Build and load the port's six hand-written CUDA kernels: simsearch,
flash attention, decode attention, the IVF band scan, the fused
two-tier probe and the embedding bag.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and one more ``nvcc`` links the
objects into ``build/repro_torch/libkernels.so`` (under the repo root,
which ``.gitignore`` lists) at first use, which is then loaded with
``ctypes``. The sources expose a plain C interface: pointers and the
CUDA stream arrive as ``void*``, and every entry point returns the
``cudaError_t`` of its launch, which :func:`launch` turns into an
exception; :func:`launch` also makes the tensors' device current for
the call. No PyTorch headers are compiled, so a build takes seconds.

Nothing here runs at import time: the CPU tests import every module of
the port on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry point in csrc/ (all return cudaError_t)
SIGNATURES = {
    # q, corpus, B, N, d, k, n_blocks, part_v, part_i, gthr, out_v, out_i,
    # stream
    "simsearch_topk": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # q, k, v, out, B, S, H, K, D, pair, scale, is_bf16, stream
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                            _I, _P],
    # q, k_cache, v_cache, lengths, out, part, tickets, B, S, H, K, D,
    # gt, chunk, scale, is_bf16, stream
    "decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _F, _I, _P],
    # q, cids, codes, scales, row_ids, B, nprobe, cap, d, C, out_v,
    # out_i, stream
    "ivf_scan_topc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # q, cids, codes, scales, row_ids, tiles, tile_ids, B, nprobe, cap,
    # n_tiles, tile, d, C, Cd, sv, si, dv, di, stream
    "fused_serve_topc": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P, _P, _P, _P, _P],
    # table, ids, weights, out, B, m, d, is_bf16, groups, stream
    "embedding_bag_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                       "built on the machine with the card")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in CSRC.glob("*.cu*"))


def _check(proc: subprocess.Popen, cmd: list) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}{err}")


def build(force: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc per source, in parallel)
    and link the shared library; a no-op when the library is newer than
    all sources."""
    if not force and not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    try:
        for _, cmd, proc in jobs:
            _check(proc, cmd)
    finally:
        for _, _, proc in jobs:    # a failed compile stops the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = LIB_PATH.with_suffix(f".{tag}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *(str(obj) for obj, _, _ in jobs)]
    _check(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), cmd)
    for obj, _, _ in jobs:
        obj.unlink()
    os.replace(tmp, LIB_PATH)   # atomic: no loader sees a half-written .so
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, device, *args) -> None:
    """Call entry point ``name`` with ``device`` (its tensors' CUDA
    device) current: a launch, a function attribute and a device query
    all act on the current device, whatever device the stream and the
    pointers belong to. Raise if the launch reported an error (a refused
    launch never runs, and a later synchronize would not report it)."""
    import torch
    with torch.cuda.device(device):
        err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
