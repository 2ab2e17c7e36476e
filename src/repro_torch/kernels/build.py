"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each source becomes its own shared library with a plain C interface,
compiled by ``nvcc`` and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries are cached under ``build/torch_ext/`` in the
checkout, keyed by a hash of the source, the flags and the compiler path;
``build_all`` starts one ``nvcc`` per missing library, all at once.

Flags: ``sm_90a`` (Hopper) and ``-O3`` for every source, no fast-math; and
per source (``SOURCES``): ``-fmad=false`` for the RL kernels, so that
``a*b + c`` is never contracted into an FMA and they round exactly like
the expression order of their plain versions (they are held bit for bit).
The attention kernels and the selective scan are held by tolerances and
build without it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
EXACT = ("-fmad=false",)
# name -> (source file, flags of that source beyond FLAGS)
SOURCES = {"env_step": ("env_step.cu", EXACT), "gae": ("gae.cu", EXACT),
           "replay_ring": ("replay_ring.cu", EXACT),
           "sum_tree": ("sum_tree.cu", EXACT),
           "flash_attention": ("flash_attention.cu", ()),
           "decode_attention": ("decode_attention.cu", ()),
           "selective_scan": ("selective_scan.cu", ())}
FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_ext"

_loaded: Dict[str, ctypes.CDLL] = {}
# held while a library is built and loaded: threads that launch at once
# (a learner thread beside the collect, sampler threads) on a cold cache
# must not start two ``nvcc`` runs into one temporary file
_load_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def flags(name: str) -> tuple:
    """nvcc's flags for the source ``name``."""
    return FLAGS + SOURCES[name][1]


def _lib_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / SOURCES[name][0]).read_bytes())
    h.update(" ".join(flags(name)).encode())
    h.update(nvcc.encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in ``names`` (default: all) in
    parallel. Returns the seconds each compile took, from the common start
    to its own end (0.0 when cached).
    Raises with the compiler's output if any compile fails."""
    nvcc = nvcc_path()
    names = list(SOURCES if names is None else names)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name, nvcc)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *flags(name), "-o", str(tmp),
             str(CSRC / SOURCES[name][0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out.parent / "build.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name][0]} (rc {proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) for the
    cached build of ``name``."""
    log = _lib_path(name, nvcc_path()).parent / "build.log"
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(_lib_path(name, nvcc_path())))
                _loaded[name] = lib
    return lib
