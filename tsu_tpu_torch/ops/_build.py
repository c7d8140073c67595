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
    """Build ``sources`` (file names under csrc/) into a shared library,
    unless a build of the same sources, headers and flags exists; return its
    path."""
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
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(_CSRC / s) for s in sources)]
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
    lib.tsu_fused_sweep_batched.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.tsu_fused_sweep_batched.restype = i
    return lib


@functools.cache
def bond_sweep_library() -> ctypes.CDLL:
    """The bond half-sweep kernel library (the single-lattice and the
    batched kernel), built and loaded once per process."""
    lib = ctypes.CDLL(str(library_path("checkerboard_bonds",
                                       ("checkerboard_bonds.cu",))))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tsu_bond_halfsweep.argtypes = [p, p, p, p, p, p, p, i, i, f, p, p, i, i, i, i, u, u, p]
    lib.tsu_bond_halfsweep.restype = i
    lib.tsu_bond_halfsweep_batched.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p, p,
                                               i, i, i, i, i, p]
    lib.tsu_bond_halfsweep_batched.restype = i
    return lib
