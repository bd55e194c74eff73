"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/lib<name>_<hash>.so`` at the repository root
(a git-ignored directory) the first time it is needed, then loaded with
``ctypes``. No source includes PyTorch's headers: a plain C interface
builds in seconds, where a PyTorch extension takes minutes. The hash
covers the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load", "build_all", "error_string", "NVCC_FLAGS", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of each kernel library's entry points: (argtypes, restype)
SIGNATURES = {
    "ragged_paged_attention": {
        # pointers (q, pools, table, lens, out, workspace, tickets), dtype,
        # sizes, the split plan (rows, splits, chunk), strides (q, pools,
        # out), table stride, scale, stream
        "rpa_launch": ([_P] * 9 + [_I] * 11 + [_L] * 10
                       + [ctypes.c_float, _P], _I),
        # pointers (q, pools, scales, table, lens, out, workspace,
        # tickets), dtype, payload, sizes, the split plan, strides (q,
        # pools, out, scales), table stride, scale, stream
        "rpa_quant_launch": ([_P] * 11 + [_I] * 12 + [_L] * 12
                             + [ctypes.c_float, _P], _I),
        # the tile path (prefill and suffix rows): rpa_launch's arguments
        # and the pool's page count; rpa_quant_launch's
        "rpa_tile_launch": ([_P] * 7 + [_I] * 9 + [_L] * 10
                            + [ctypes.c_float, _P], _I),
        "rpa_tile_quant_launch": ([_P] * 9 + [_I] * 9 + [_L] * 12
                                  + [ctypes.c_float, _P], _I),
        # q, k, v, s_out, o_out, stream
        "hopper_wgmma_check": ([_P] * 6, _I),
        "rpa_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention": {
        # pointers, dtype, B, L, S, H, D, causal, scale, strides, stream
        "flash_fwd_launch": ([_P] * 5 + [_I] * 7 + [ctypes.c_float, _P, _P],
                             _I),
        # q, k, v, out, dout, lse, lse2, delta, dq_acc, dq, dk, dv, then
        # as above
        "flash_bwd_launch": ([_P] * 12 + [_I] * 7
                             + [ctypes.c_float, _P, _P], _I),
        "flash_bwd_dq_launch": ([_P] * 7 + [_I] * 7
                                + [ctypes.c_float, _P, _P], _I),
        "flash_bwd_dkv_launch": ([_P] * 8 + [_I] * 7
                                 + [ctypes.c_float, _P, _P], _I),
        # x, k, out, D, stream
        "flash_bwd_wgmma_check": ([_P] * 3 + [_I, _P], _I),
    },
    "block_sparse_attention": {
        # tensor pointers, the tile plan (ptr, ent, bits), the pair plan
        # (ptr, ent, order), dtype, B, T, H, D, scale, strides, stream
        "bsa_fwd_launch": ([_P] * 11 + [_I] * 5 + [ctypes.c_float, _P, _P],
                           _I),
        # q, k, v, out, dout, lse, lse2, delta, dq_acc, dq, dk, dv, the
        # pair plan (ptr, ent, bits, order), then as above
        "bsa_bwd_launch": ([_P] * 16 + [_I] * 5 + [ctypes.c_float, _P, _P],
                           _I),
        # tensor pointers, the tile plan (ptr, ent, bits), then as above
        "bsa_bwd_dq_launch": ([_P] * 10 + [_I] * 5
                              + [ctypes.c_float, _P, _P], _I),
        "bsa_bwd_dkv_launch": ([_P] * 11 + [_I] * 5
                               + [ctypes.c_float, _P, _P], _I),
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file beside its target;
    returns (process, tmp path, target) or None when already built."""
    so = _target(name)
    if so.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except OSError:
        os.unlink(tmp)
        raise
    return proc, tmp, so


def _finish(name: str, started) -> str:
    proc, tmp, so = started
    out, err = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(exit {proc.returncode}):\n{err}{out}")
    os.replace(tmp, so)             # atomic: a half-written .so never loads
    so.with_suffix(".log").write_text(err + out)
    return err + out


def build_all(names=None) -> dict:
    """Build every kernel source (or ``names``) at once, one nvcc per
    source started together. Returns {name: {"seconds", "log"}}; "log" is
    nvcc's output (ptxas register/spill lines), or "" when the library was
    already built."""
    names = list(names or sorted(p.stem for p in CSRC.glob("*.cu")))
    t0 = time.perf_counter()
    started = {}
    try:
        for n in names:
            started[n] = _start(n)
        report = {}
        for n, s in started.items():
            log = "" if s is None else _finish(n, s)
            report[n] = {"seconds": time.perf_counter() - t0, "log": log}
        return report
    finally:       # a failed build leaves no other nvcc running
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
                os.unlink(s[1])


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed, with argtypes
    and restype set for each entry point."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    lib = ctypes.CDLL(str(_target(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def error_string(err: int) -> str:
    """CUDA's name for an error code returned by a launch."""
    msg = load("ragged_paged_attention").rpa_error_string(int(err))
    return msg.decode() if msg else "unknown"
