"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  Builds run
at first use, from the repo's sources alone, into ``build/kernels/`` at
the checkout root (listed in ``.gitignore``), keyed by a hash of the
sources and flags so an edited kernel is rebuilt.  ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point and argtypes of each kernel library
SIGNATURES: Dict[str, Tuple[str, tuple]] = {
    "ragged_prefill_paged": (
        "ragged_prefill_paged_launch", (_P,) * 8 + (_I,) * 11 + (_P,)),
    "decode_attn_paged": (
        "decode_attn_paged_launch", (_P,) * 7 + (_I,) * 10 + (_P,)),
    "ragged_prefill_arena": (
        "ragged_prefill_arena_launch", (_P,) * 8 + (_I,) * 9 + (_P,)),
    "ragged_prefill_attn": (
        "ragged_prefill_attn_launch", (_P,) * 7 + (_I,) * 8 + (_P,)),
    "decode_attn_arena": (
        "decode_attn_arena_launch", (_P,) * 7 + (_I,) * 9 + (_P,)),
    "fused_sample": (
        "fused_sample_launch", (_P,) * 11 + (_I,) * 5 + (_P,)),
    "ssd_scan": (
        "ssd_scan_launch", (_P,) * 10 + (_I,) * 11 + (_P,)),
    "ssd_scan_bwd": (
        "ssd_scan_bwd_launch", (_P,) * 15 + (_I,) * 11 + (_P,)),
    "flash_attn": (
        "flash_attn_launch", (_P,) * 7 + (_I,) * 9 + (_P,)),
    "flash_attn_bwd": (
        "flash_attn_bwd_launch", (_P,) * 12 + (_I,) * 9 + (_P,)),
    "decode_attn_dense": (
        "decode_attn_dense_launch", (_P,) * 7 + (_I,) * 8 + (_P,)),
}

_loaded: Dict[str, ctypes._CFuncPtr] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the hash of every
    source in csrc/ (the .cu and the headers it includes) and the
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Build every named kernel library not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: compiler log} (the
    ``-Xptxas -v`` lines: registers, shared memory, spills per kernel);
    raises with the log when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        procs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, so)              # atomic: concurrent builds
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    logs = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def launcher(name: str) -> ctypes._CFuncPtr:
    """The C launch function of kernel ``name``, building its library at
    first use.  Every argument is declared: ``c_void_p`` for pointers and
    the stream, ``c_int`` for ints; the return is the launch's
    ``cudaGetLastError()``."""
    fn = _loaded.get(name)
    if fn is None:
        fn = function(name, *SIGNATURES[name])
        _loaded[name] = fn
    return fn


def function(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """C function ``symbol`` of kernel ``name``'s library, building the
    library at first use; it returns an int."""
    lib = _libs.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(so))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
