"""ctypes bindings for the host graph tools (``graph_tools.cpp``).

The C++ source is the JAX package's, copied unchanged. It is compiled with
``g++ -O3 -shared -fPIC`` at first use into ``build/tsu_tpu_torch/`` at the
repository root, under a name keyed by a hash of the source and the flags,
and loaded with ctypes. No ``-march=native``: the build directory may be
shared between hosts. A build or load that fails raises; there is no
pure-Python fall-back, so a missing toolchain never changes which chain or
bound a caller gets.

The library holds the host paths of small problems and the graph bounds:
greedy local-search MAX-CUT, cut values, colouring conflicts, simulated
annealing and heat-bath Gibbs sampling of a dense bit-Boltzmann (J, h).
``native_available`` says whether the library builds and loads here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "graph_tools.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tsu_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    """Build the graph tools unless a build of the same source and flags
    exists; return the library's path."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(_SOURCE.read_bytes())
    out = BUILD_DIR / f"graph_tools-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native graph tools need a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The graph-tools library, built and loaded once per process."""
    lib = ctypes.CDLL(str(library_path()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.greedy_maxcut.restype = ctypes.c_double
    lib.greedy_maxcut.argtypes = [i64p, i32p, f64p, ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_uint64, i8p]
    lib.cut_value.restype = ctypes.c_double
    lib.cut_value.argtypes = [i64p, i32p, f64p, ctypes.c_int64, i8p]
    lib.coloring_conflicts.restype = ctypes.c_int64
    lib.coloring_conflicts.argtypes = [i64p, i32p, ctypes.c_int64, i32p]
    lib.sa_dense.restype = ctypes.c_double
    lib.sa_dense.argtypes = [f32p, f32p, ctypes.c_int32, f32p, ctypes.c_int32, ctypes.c_int32,
                             ctypes.c_uint64, f32p]
    lib.gibbs_dense.restype = ctypes.c_int32
    lib.gibbs_dense.argtypes = [f32p, f32p, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_uint64, f32p]
    return lib


def native_available() -> bool:
    """Whether the graph tools build and load on this machine. A query only:
    every entry point still raises when they do not."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def csr_from_dense(W: np.ndarray):
    """Dense symmetric weight matrix -> CSR (indptr, indices, weights)."""
    from scipy import sparse

    csr = sparse.csr_matrix(np.asarray(W, dtype=np.float64))
    return (csr.indptr.astype(np.int64), csr.indices.astype(np.int32),
            csr.data.astype(np.float64))


def csr_from_edges(n: int, edges: np.ndarray, weights: np.ndarray):
    """Undirected edge list -> symmetric CSR (duplicate edges summed)."""
    from scipy import sparse

    e = np.asarray(edges)
    w = np.asarray(weights, dtype=np.float64)
    m = sparse.coo_matrix((np.concatenate([w, w]),
                           (np.concatenate([e[:, 0], e[:, 1]]),
                            np.concatenate([e[:, 1], e[:, 0]]))),
                          shape=(n, n)).tocsr()
    return (m.indptr.astype(np.int64), m.indices.astype(np.int32),
            m.data.astype(np.float64))


def _csr(indptr, indices, weights):
    return (np.ascontiguousarray(indptr, np.int64), np.ascontiguousarray(indices, np.int32),
            np.ascontiguousarray(weights, np.float64))


def greedy_maxcut_csr(indptr, indices, weights, n_restarts: int = 10, seed: int = 0):
    """Greedy local-search cut (a lower bound on the max cut): the best of
    ``n_restarts`` random starts, each flipped site by site until no flip
    gains. Returns (cut, spins (n,) float64 of ±1)."""
    n = len(indptr) - 1
    spins = np.zeros(n, dtype=np.int8)
    cut = library().greedy_maxcut(*_csr(indptr, indices, weights), n, int(n_restarts),
                                  int(seed) & (2**64 - 1), spins)
    if cut < 0:
        raise MemoryError("greedy_maxcut could not allocate its work arrays")
    return float(cut), spins.astype(np.float64)


def cut_value_csr(indptr, indices, weights, spins) -> float:
    """Cut of a ±1 assignment (each undirected edge counted once)."""
    n = len(indptr) - 1
    s8 = np.where(np.asarray(spins) > 0, 1, -1).astype(np.int8)
    return float(library().cut_value(*_csr(indptr, indices, weights), n, s8))


def coloring_conflicts_csr(indptr, indices, colors) -> int:
    """Edges whose two ends share a colour."""
    n = len(indptr) - 1
    return int(library().coloring_conflicts(
        np.ascontiguousarray(indptr, np.int64), np.ascontiguousarray(indices, np.int32), n,
        np.ascontiguousarray(colors, np.int32)))


def sa_dense_native(J, h, schedule, n_chains: int, seed: int):
    """Simulated annealing of a dense bit-Boltzmann (J, h) on the host: site
    by site in index order, one sweep per temperature of ``schedule``,
    ``n_chains`` chains one after another. Returns (best_state (n,) float32,
    best_energy float)."""
    J = np.ascontiguousarray(J, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    schedule = np.ascontiguousarray(schedule, np.float32)
    n = J.shape[0]
    best_state = np.zeros(n, dtype=np.float32)
    e = library().sa_dense(J, h, n, schedule, len(schedule), int(n_chains),
                           int(seed) & (2**64 - 1), best_state)
    if e >= 1e299:
        raise MemoryError("sa_dense could not allocate its work arrays")
    return best_state, float(e)


def gibbs_dense_native(J, h, *, temperature: float, n_chains: int, n_samples: int,
                       n_burnin: int, n_sweeps: int, random_order: bool, seed: int):
    """Heat-bath Gibbs sampling of a dense bit-Boltzmann (J, h) on the host:
    site-ordered sweeps, or a fresh random permutation per sweep, chains
    interleaved round-robin in the output. Returns (n_samples, n) float32
    bits."""
    J = np.ascontiguousarray(J, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    n = J.shape[0]
    out = np.zeros((n_samples, n), dtype=np.float32)
    rc = library().gibbs_dense(J, h, n, float(temperature), int(n_chains), int(n_samples),
                               int(n_burnin), int(n_sweeps), 1 if random_order else 0,
                               int(seed) & (2**64 - 1), out)
    if rc != 0:
        raise MemoryError("gibbs_dense could not allocate its work arrays")
    return out
