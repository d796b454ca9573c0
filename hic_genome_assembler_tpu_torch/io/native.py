"""ctypes bindings for the native C++ IO runtime.

The compute path is on the device; the IO runtime around it is native
where the data volume warrants it — here, the validPairs stream filter
(orientSmallScaffolds.py:159-177's hot loop #3, SURVEY.md §3.3).  The
shared library is built on demand with g++ -O3 from the package's own
sources in ``csrc/hostio/`` into ``build/hostio/`` at the repository
root; every native entry point has a pure-Python fallback at its call
site, so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc", "hostio")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hostio")
_SO_PATH = os.path.join(_BUILD_DIR, "libhicio.so")
_SOURCES = [
    os.path.join(_SRC_DIR, "validpairs_scanner.cpp"),
    os.path.join(_SRC_DIR, "coo_parser.cpp"),
    os.path.join(_SRC_DIR, "distance_transform.cpp"),
    os.path.join(_SRC_DIR, "louvain_sweep.cpp"),
    os.path.join(_SRC_DIR, "argsort_rows.cpp"),
    os.path.join(_SRC_DIR, "permute_f64.cpp"),
]

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # link under a name of this process's own, then rename: processes that
    # start together (test workers, EP ranks) never load a half-written file
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-o", tmp, *_SOURCES],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _SO_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        print(f"- native IO build failed ({exc}); using pure-Python fallbacks")
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_SO_PATH) or any(
        os.path.getmtime(src) > os.path.getmtime(_SO_PATH) for src in _SOURCES
    ):
        if not _build():
            _build_failed = True
            return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.scan_validpairs.restype = ctypes.c_int
    lib.scan_validpairs.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.free_buffer.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.coo_max_rows.restype = ctypes.c_int64
    lib.coo_max_rows.argtypes = [ctypes.c_char_p]
    lib.parse_coo_into.restype = ctypes.c_int
    lib.parse_coo_into.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.distance_transform_f64.restype = None
    lib.distance_transform_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.similarity_transform_f64.restype = None
    lib.similarity_transform_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.argsort_rows_f64.restype = None
    lib.argsort_rows_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.permute_symmetric_f64.restype = None
    lib.permute_symmetric_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double),   # m
        ctypes.POINTER(ctypes.c_int64),    # order
        ctypes.POINTER(ctypes.c_double),   # out
        ctypes.c_int64,                    # n_src
        ctypes.c_int64,                    # n_out
    ]
    lib.louvain_sweep_f64.restype = ctypes.c_int
    lib.louvain_sweep_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double),   # a_tilde
        ctypes.POINTER(ctypes.c_double),   # k
        ctypes.c_double,                   # two_m
        ctypes.POINTER(ctypes.c_int64),    # comm (in/out)
        ctypes.POINTER(ctypes.c_double),   # sigma (in/out)
        ctypes.POINTER(ctypes.c_int64),    # perm
        ctypes.POINTER(ctypes.c_double),   # scratch
        ctypes.c_int64,                    # n
        ctypes.c_double,                   # min_gain
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_coo(matrix_file: str):
    """Native multithreaded parse of an iced.matrix triplet file.

    Returns an (nnz, 3) float64 array in FILE ORDER (id1, id2, value) —
    order preservation keeps build_adjacency_matrix's last-write-wins
    duplicate semantics.  The parser writes straight into the returned
    numpy buffer (two-call protocol: newline count sizes the
    allocation, then threads fill disjoint regions — no intermediate
    copies).  Returns None when the native path is unavailable or the
    file is malformed (caller falls back to pandas).
    """
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    path = matrix_file.encode()
    max_rows = lib.coo_max_rows(path)
    if max_rows < 0:
        return None
    arr = np.empty((max_rows, 3), dtype=np.float64)
    out_rows = ctypes.c_int64()
    rc = lib.parse_coo_into(
        path,
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows,
        ctypes.byref(out_rows),
    )
    if rc != 0:
        return None
    nnz = out_rows.value
    if nnz == max_rows:
        return arr
    return arr[:nnz].copy()  # blank lines: shrink (rare)


def scan_validpairs(
    pair_file: str, pair_dict: Dict[Tuple[str, str], list]
) -> Dict[Tuple[str, str], list]:
    """Native filter of the validPairs stream into pair_dict.

    Produces records identical to the Python path:
    [scaff1, scaff2, int(pos1), int(pos2)] appended per matching line.
    """
    lib = _load()
    assert lib is not None
    keys = "\n".join(f"{a}\t{b}" for a, b in pair_dict.keys())
    out_data = ctypes.POINTER(ctypes.c_char)()
    out_len = ctypes.c_int64()
    rc = lib.scan_validpairs(
        pair_file.encode(),
        keys.encode(),
        len(pair_dict),
        ctypes.byref(out_data),
        ctypes.byref(out_len),
    )
    if rc != 0:
        raise OSError(f"native validpairs scan failed on {pair_file} (rc={rc})")
    try:
        blob = ctypes.string_at(out_data, out_len.value).decode()
    finally:
        if out_len.value:
            lib.free_buffer(out_data)
    # parse fully before mutating pair_dict, so a malformed blob raises
    # without leaving partial appends behind (the caller then falls back
    # to the pure-Python stream on a clean dict)
    records = []
    for line in blob.splitlines():
        s1, s2, p1, p2 = line.split("\t")
        records.append((s1, s2, int(p1), int(p2)))
    for s1, s2, p1, p2 in records:
        pair_dict[(s1, s2)].append([s1, s2, p1, p2])
    return pair_dict


def distance_transform_f64(matrix, row_sums):
    """Fused threaded f64 distance transform (native/distance_transform.cpp):
    out[i, j] = (1 - matrix[i, j] / row_sums[i]) + 1, bit-identical to the
    numpy expression (same per-element IEEE op sequence; elementwise, so
    threading cannot reorder anything).  Returns a new array."""
    import numpy as np

    lib = _load()
    assert lib is not None
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    rs = np.ascontiguousarray(np.ravel(row_sums), dtype=np.float64)
    assert rs.shape[0] == m.shape[0]
    out = np.empty_like(m)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.distance_transform_f64(
        m.ctypes.data_as(dp),
        rs.ctypes.data_as(dp),
        out.ctypes.data_as(dp),
        m.shape[0],
        m.shape[1],
    )
    return out


def permute_symmetric_f64(matrix, order):
    """Threaded symmetric permute/subset gather
    out[i, j] = m[order[i], order[j]] (native/permute_f64.cpp) —
    bit-identical to ``matrix[np.ix_(order, order)]`` (pure data
    movement), ~10x on a 16K matrix.  ``order`` may select a subset
    (zero-row pruning) or a full permutation."""
    import numpy as np

    lib = _load()
    assert lib is not None
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    n = m.shape[0]
    assert m.shape == (n, n)
    o = np.ascontiguousarray(order, dtype=np.int64)
    n_out = o.shape[0]
    out = np.empty((n_out, n_out), dtype=np.float64)
    lib.permute_symmetric_f64(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        o.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        n_out,
    )
    return out


def louvain_sweep_f64(a_tilde, k, two_m, comm, sigma, perm, scratch, min_gain):
    """One native Louvain local-move sweep (native/louvain_sweep.cpp).
    Mutates ``comm`` and ``sigma`` in place; returns True if any move
    was accepted.  Bit-identical to the numpy oracle sweep."""
    lib = _load()
    assert lib is not None
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    return bool(
        lib.louvain_sweep_f64(
            a_tilde.ctypes.data_as(dp),
            k.ctypes.data_as(dp),
            float(two_m),
            comm.ctypes.data_as(ip),
            sigma.ctypes.data_as(dp),
            perm.ctypes.data_as(ip),
            scratch.ctypes.data_as(dp),
            a_tilde.shape[0],
            float(min_gain),
        )
    )


def argsort_rows_f64(matrix, reverse=True):
    """Row-parallel numpy-introsort-identical argsort
    (native/argsort_rows.cpp).  Returns int64 (n_rows, n_cols); with
    ``reverse`` each row is reversed (the rank-matrix ``[:, ::-1]``)."""
    import numpy as np

    lib = _load()
    assert lib is not None
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    out = np.empty(m.shape, dtype=np.int64)
    lib.argsort_rows_f64(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        m.shape[0],
        m.shape[1],
        1 if reverse else 0,
    )
    return out


def similarity_transform_f64(matrix, row_sums):
    """Fused threaded f64 similarity inverse (same contract as
    :func:`distance_transform_f64`): out[i, j] = rs[i]*(1-(m[i, j]-1)),
    bit-identical to the numpy expression."""
    import numpy as np

    lib = _load()
    assert lib is not None
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    rs = np.ascontiguousarray(np.ravel(row_sums), dtype=np.float64)
    assert rs.shape[0] == m.shape[0]
    out = np.empty_like(m)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.similarity_transform_f64(
        m.ctypes.data_as(dp),
        rs.ctypes.data_as(dp),
        out.ctypes.data_as(dp),
        m.shape[0],
        m.shape[1],
    )
    return out
