"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries go to ``build/repro_torch/`` at the repository root,
named by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once. ``build_all`` starts one ``nvcc`` per
source in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("predicate_bitmap", "fused_scan_agg", "grouped_agg", "bitmap_apply",
           "shuffle")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PROG = [_P, _I, _P, _P, _I, _P, _P, _I]  # ops .. n_cols (program.cuh)
SIGNATURES = {
    "predicate_bitmap": {
        "predicate_bitmap_launch": _PROG + [_LL, _I, _P, _P]},
    "fused_scan_agg": {  # ids, value pointers, f64 flags, V, R, G, ...
        "fused_scan_agg_launch": _PROG + [_P, _P, _P, _I, _LL, _I, _P, _P, _I,
                                          _P]},
    "grouped_agg": {  # ids, values, vdt, R, G, then each regime's own
        "grouped_agg_smem_launch": [_P, _P, _I, _LL, _I, _I, _I, _I, _I, _I,
                                    _P, _P, _P],
        "grouped_agg_l2_launch": [_P, _P, _I, _LL, _I, _I, _I, _P, _P, _P],
        "grouped_agg_range_launch": [_P, _P, _I, _LL, _I, _I, _I, _I, _LL,
                                     _I, _I, _I, _P, _P, _P, _P, _P, _P]},
    "bitmap_apply": {  # segment table, n_seg, n_chunks, counts, sms, stream
        "bitmap_apply_launch": [_P, _I, _LL, _P, _I, _P],
        "bitmap_apply_chunk_rows": []},
    "shuffle": {
        "hash_partition_launch": [_P, _I, _LL, _I, _P, _P, _I, _P],
        "fused_scan_shuffle_launch": _PROG + [_P, _I, _LL, _I, _P, _P, _P, _I,
                                              _P]},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, tmp: Path) -> subprocess.Popen:
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every kernel library not loaded yet."""
    with _LOCK:
        todo = {n: _lib_path(n) for n in SOURCES if n not in _LIBS}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmps = {n: p.with_suffix(f".{os.getpid()}.tmp")
                for n, p in todo.items() if not p.exists()}
        procs = {n: _start(n, tmp) for n, tmp in tmps.items()}
        failed = []
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {n}.cu failed:\n{log}")
            else:
                os.replace(tmps[n], todo[n])
        if failed:
            raise RuntimeError("\n".join(failed))
        for n, p in todo.items():
            _LIBS[n] = _load(n, p)
        return dict(_LIBS)


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all()[name]
