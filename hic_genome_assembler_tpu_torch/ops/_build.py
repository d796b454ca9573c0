"""Build and load the port's CUDA kernels.

The kernels in ``hic_genome_assembler_tpu_torch/csrc/*.cu`` expose plain C
entry points.  At first use each source is compiled with ``nvcc`` for
Hopper (``sm_90a``), all of them at once in parallel processes, and the
objects are linked into ``build/kernels/libkernels.so`` at the repository
root and loaded with ``ctypes``; the build is redone whenever the hash of
the sources or of the flags changes.  ``build/kernels/nvcc.log`` keeps
ptxas' report of each kernel's registers, shared memory and spills.
Nothing here runs at import time: the CPU test machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
_LIB_NAME = "libkernels.so"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
LOG = BUILD_DIR / "nvcc.log"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> float:
    """Compile the kernels if the sources changed; return the seconds the
    compile took (0.0 when the cached library is current)."""
    sources = _sources()
    digest = _digest(sources)
    lib = BUILD_DIR / _LIB_NAME
    stamp = BUILD_DIR / (_LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = BUILD_DIR / f"{_LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    compiles = [
        [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in compiles
    ]
    results = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(compiles, procs, results):
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}\n{}".format(" ".join(cmd), out, err))
    LOG.write_text("".join(f"== {src.name}\n{out}{err}"
                           for src, (out, err) in zip(sources, results)))
    link = [nvcc, *_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed ({}):\n{}\n{}".format(" ".join(link), proc.stdout, proc.stderr)
        )
    for obj in objects:
        obj.unlink()
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    build()
    lib = ctypes.CDLL(str(BUILD_DIR / _LIB_NAME))
    lib.rank_counts.argtypes = [
        ctypes.c_void_p,   # const int32_t* R
        ctypes.c_int64,    # row stride (elements)
        ctypes.c_int,      # n_rows
        ctypes.c_int,      # n_cols
        ctypes.c_int,      # row0: global row of the block's first row
        ctypes.c_int,      # col0: global column of the block's first column
        ctypes.c_void_p,   # const int32_t* params [K, 3]
        ctypes.c_int,      # K
        ctypes.c_void_p,   # int32_t* out [K, n_rows]
        ctypes.c_void_p,   # cudaStream_t
    ]
    lib.rank_counts.restype = ctypes.c_int
    lib.hmm_forward_backward.argtypes = [
        ctypes.c_void_p,   # const double* log_b [T, 2]
        ctypes.c_void_p,   # const double* log_start [2]
        ctypes.c_void_p,   # const double* log_trans [2, 2]
        ctypes.c_int,      # T
        ctypes.c_void_p,   # double* scratch [2, T, 2]
        ctypes.c_void_p,   # double* gamma [T, 2]
        ctypes.c_void_p,   # double* xi_sum [2, 2]
        ctypes.c_void_p,   # double* logprob [1]
        ctypes.c_void_p,   # cudaStream_t
    ]
    lib.hmm_forward_backward.restype = ctypes.c_int
    lib.hmm_viterbi.argtypes = [
        ctypes.c_void_p,   # const double* log_b [T, 2]
        ctypes.c_void_p,   # const double* log_start [2]
        ctypes.c_void_p,   # const double* log_trans [2, 2]
        ctypes.c_int,      # T
        ctypes.c_void_p,   # uint8_t* scratch [max(T - 1, 1), 2]
        ctypes.c_void_p,   # int32_t* path [T]
        ctypes.c_void_p,   # cudaStream_t
    ]
    lib.hmm_viterbi.restype = ctypes.c_int
    return lib
