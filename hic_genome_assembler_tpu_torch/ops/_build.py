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


_PTR, _INT, _I64, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double

# The argument types of every C entry point of csrc/*.cu, in order: each
# pointer and the cudaStream_t (last) as c_void_p, else ctypes would pass a
# 32-bit int and cut it; a double as c_double.  Every entry point returns its cudaError_t as int.
SIGNATURES = {
    # R, element bytes, row stride, n_rows, n_cols, row0, col0, plan, n_chunks,
    # max_bins, max_groups, out [K, n_rows]
    "rank_counts": [_PTR, _INT, _I64, _INT, _INT, _INT, _INT, _PTR, _INT, _INT, _INT, _PTR,
                    _PTR],
    # log_b [T, 2], log_start [2], log_trans [2, 2], T, scratch [2, T, 2],
    # gamma [T, 2], xi_sum [2, 2], logprob [1]
    "hmm_forward_backward": [_PTR, _PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR],
    # log_b, log_start, log_trans, T, scratch uint8 [max(T - 1, 1), 2], path int32 [T]
    "hmm_viterbi": [_PTR, _PTR, _PTR, _INT, _PTR, _PTR, _PTR],
    # M [C, C], C, sizes int64 [Sp], Sp, cmax, pairs a block, h [4*Sp*Sp, 2*cmax - 1]
    "pair_profiles": [_PTR, _INT, _PTR, _INT, _INT, _INT, _PTR, _PTR],
    # F, F's numel, idx4 [n_combo, 4], n_combo, cid [Bo, P], Bo, orients [R, S],
    # R, S, c0, k, n0, N_glob, tile, parts scratch, costs, vals, idx, second
    "combo_score_topk": [_PTR, _I64, _PTR, _INT, _PTR, _I64, _PTR, _INT, _INT, _PTR, _INT,
                         _I64, _I64, _I64, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR],
    # x [N], N, k, tile, parts scratch, vals, idx, second
    "group_topk": [_PTR, _I64, _INT, _I64, _PTR, _PTR, _PTR, _PTR, _PTR],
    # in vals [D, k], in idx [D, k], in second [D, k], D, k, vals, idx, second
    "topk_fold": [_PTR, _PTR, _PTR, _INT, _INT, _PTR, _PTR, _PTR, _PTR],
    # F, C + 1, sizes, Sp, orders [Bo, S], Bo, S, orients [R, S], R, halves, c0, k,
    # n0, N_glob, tile, parts scratch, costs [Bo, R], vals, idx, second
    "block_score": [_PTR, _I64, _PTR, _INT, _PTR, _I64, _INT, _PTR, _INT, _INT, _PTR, _INT,
                    _I64, _I64, _I64, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR],
    # F, C + 1, sizes, Sp, cand [B, 2*W], B, W, c0, out [B]
    "pair_score": [_PTR, _I64, _PTR, _INT, _PTR, _INT, _INT, _PTR, _PTR, _PTR],
    # X [n, d], n, d, mean [d], var0 [d], covars [2, d] or null
    "kmeans_col_stats": [_PTR, _INT, _INT, _PTR, _PTR, _PTR, _PTR],
    # X, mean, n, d, rows a block, Xc [n, d], x_sq [n]
    "kmeans_center": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR],
    # Xc, x_sq, n, d, rows, first, closest [n]
    "kmeans_seed_closest": [_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR, _PTR],
    # Xc, x_sq, closest, n, d, rows, cand0, cand1, part [blocks, 2]
    "kmeans_seed_pots": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR],
    # Xc, x_sq, part, blocks, d, first, cand0, cand1, centers [2, d], cn [2]
    "kmeans_seed_pick": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR],
    # Xc, n, d, rows, centers, cn, labels_in or null, labels_out, relabel, best or null,
    # part_sums [blocks, 2, d], part_inertia [blocks], part_counts [blocks, 6]
    "kmeans_step": [_PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR,
                    _PTR],
    # part_sums, part_counts, blocks, n, d, centers, var0, centers_new, cn_new,
    # tile_part [tiles, 5], ticket [1] (0), status [5]
    "kmeans_fold": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                    _PTR],
    # part_inertia, part_counts, blocks, n, d, first_init, centers, mean, labels,
    # best_centers, best_labels, best_inertia
    "kmeans_choose": [_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                      _PTR],
    # M [C, C] f64, row stride, bin orders int32 [B, K], B, K, numpy's chunk, total,
    # traces scratch [B, K], tickets [B] (zeroed), costs [B]
    "f64_rescore": [_PTR, _I64, _PTR, _INT, _INT, _INT, _F64, _PTR, _PTR, _PTR, _PTR],
    # W [n, n] f64 (made symmetric, consumed), n, size int32 [n], chain int32 [n],
    # merges zx, zy int32 [n - 1], zd f64 [n - 1], zs int32 [n - 1]
    "upgma_linkage": [_PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set every entry point's argument and result types on ``lib``."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    build()
    return bind(ctypes.CDLL(str(BUILD_DIR / _LIB_NAME)))
