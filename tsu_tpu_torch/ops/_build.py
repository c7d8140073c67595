"""Build the port's CUDA sources with nvcc at first use and load them.

Each library is compiled into ``build/tsu_tpu_torch/`` at the repository root,
under a name keyed by a hash of its sources and flags, with a plain C
interface, and loaded through ``ctypes``. Nothing is built when a module is
imported: the first call that launches a kernel builds it.
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

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tsu_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    """Build ``sources`` (file names under csrc/, or paths elsewhere that
    include its headers) into a shared library, unless a build of the same
    sources, headers and flags exists; return its path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(p.name for p in _CSRC.glob("*.cuh"))):
        digest.update((_CSRC / src).read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name and rename, so that concurrent processes
    # never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", tmp,
               *(str(_CSRC / s) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def fused_sweep_library() -> ctypes.CDLL:
    """The fused-sweep kernel library (the single-lattice and the batched
    kernel), built and loaded once per process."""
    lib = ctypes.CDLL(str(library_path("checkerboard_fused",
                                       ("checkerboard_fused.cu",))))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.tsu_fused_sweep.argtypes = [p, p, p, p, p, i, i, i, u, u, i, p]
    lib.tsu_fused_sweep.restype = i
    lib.tsu_fused_sweep_shard.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, u,
                                          u, i, p]
    lib.tsu_fused_sweep_shard.restype = i
    lib.tsu_fused_sweep_batched.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.tsu_fused_sweep_batched.restype = i
    lib.tsu_decomposition_sweep.argtypes = [i, p, p, p, p, i, i, i, u, u, i, p]
    lib.tsu_decomposition_sweep.restype = i
    return lib


@functools.cache
def resident_sweep_library() -> ctypes.CDLL:
    """The resident multi-sweep kernel library (one cooperative launch runs
    S sweeps), built and loaded once per process."""
    return resident_library(library_path("checkerboard_resident",
                                         ("checkerboard_resident.cu",)))


def resident_library(path) -> ctypes.CDLL:
    """Load a build of a version of ``checkerboard_resident.cu`` and declare
    its C entries: the banded body's ``tsu_resident_run``,
    ``tsu_resident_limits`` and ``tsu_resident_occupancy``, or the
    grid-stride body's ``tsu_resident_sweeps``
    (``checkerboard_resident_gridstride.cu``)."""
    lib = ctypes.CDLL(str(path))
    p, i, u, ip = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.POINTER(ctypes.c_int)
    if hasattr(lib, "tsu_resident_run"):
        lib.tsu_resident_run.argtypes = [p, p, p, i, p, i, i, i, i, u, i, i, i, i, i, p, p, p]
        lib.tsu_resident_run.restype = i
        lib.tsu_resident_limits.argtypes = [ip, ip, ip]
        lib.tsu_resident_limits.restype = i
        lib.tsu_resident_occupancy.argtypes = [i, i, ip]
        lib.tsu_resident_occupancy.restype = i
    else:
        lib.tsu_resident_sweeps.argtypes = [p, p, p, i, p, i, i, i, i, u, i, ip, p]
        lib.tsu_resident_sweeps.restype = i
    return lib


@functools.cache
def halfsweep_library() -> ctypes.CDLL:
    """The exact-sigmoid half-sweep kernel library (one lattice or one
    shard, with optional column halos), built and loaded once per process."""
    return halfsweep_body_library(library_path("checkerboard_halfsweep",
                                               ("checkerboard_halfsweep.cu",)))


def halfsweep_body_library(path) -> ctypes.CDLL:
    """Load a build of a version of the half-sweep kernel and declare its C
    entry: the strip body's ``tsu_halfsweep``, whose column halos carry row
    strides, or the first body's ``tsu_halfsweep_scalar``
    (``checkerboard_halfsweep_scalar.cu``), whose columns are contiguous."""
    lib = ctypes.CDLL(str(path))
    p, i, u, f, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_longlong
    if hasattr(lib, "tsu_halfsweep_scalar"):
        lib.tsu_halfsweep_scalar.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, f, f, i, i, u, u,
                                             i, p]
        lib.tsu_halfsweep_scalar.restype = i
    else:
        lib.tsu_halfsweep.argtypes = [p, p, p, p, p, p, s, s, p, i, i, i, i, f, f, f, i, i, u, u,
                                      i, p]
        lib.tsu_halfsweep.restype = i
    return lib


@functools.cache
def bond_sweep_library() -> ctypes.CDLL:
    """The bond half-sweep kernel library (the single-lattice and the
    batched kernel), built and loaded once per process."""
    return bond_library(library_path("checkerboard_bonds", ("checkerboard_bonds.cu",)))


@functools.cache
def houdayer_cluster_library() -> ctypes.CDLL:
    """The Houdayer cluster-move kernel library (one launch a move of a batch
    of replica pairs), built and loaded once per process."""
    lib = ctypes.CDLL(str(library_path("houdayer_cluster", ("houdayer_cluster.cu",))))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tsu_houdayer_cluster.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.tsu_houdayer_cluster.restype = i
    lib.tsu_houdayer_smem_limit.argtypes = [ctypes.POINTER(i)]
    lib.tsu_houdayer_smem_limit.restype = i
    return lib


@functools.cache
def dense_colour_sweep_library() -> ctypes.CDLL:
    """The dense colour-sweep kernel library (one launch a sweep of a batch
    of chains), built and loaded once per process."""
    lib = ctypes.CDLL(str(library_path("dense_colour_sweep", ("dense_colour_sweep.cu",))))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tsu_dense_colour_sweep.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                           ctypes.c_longlong, p]
    lib.tsu_dense_colour_sweep.restype = i
    lib.tsu_dense_colour_sweep_blocks_per_sm.argtypes = [i, i, ctypes.c_longlong,
                                                         ctypes.POINTER(i)]
    lib.tsu_dense_colour_sweep_blocks_per_sm.restype = i
    return lib


def bond_library(path) -> ctypes.CDLL:
    """Load a build of a version of ``checkerboard_bonds.cu`` and declare
    its two C entries."""
    lib = ctypes.CDLL(str(path))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tsu_bond_halfsweep.argtypes = [p, p, p, p, p, p, p, i, i, f, p, p, i, i, i, i, u, u, p]
    lib.tsu_bond_halfsweep.restype = i
    lib.tsu_bond_halfsweep_batched.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p, p,
                                               i, i, i, i, i, p]
    lib.tsu_bond_halfsweep_batched.restype = i
    return lib
