"""The seam between the port and its CUDA sources: build, load and call.

Each library, ``csrc/<name>.cu``, is compiled with nvcc into
``build/tsu_tpu_torch/`` at the repository root, under a name keyed by a hash
of its sources and flags, with a plain C interface, and loaded through
``ctypes`` with the C entries that ``ENTRIES`` declares for it. Nothing is
built when a module is imported: the first call that launches a kernel
builds it. Every launch and every card query of the kernel wrappers runs
through :func:`call`. A new kernel adds its ``.cu`` file, its rows in
``ENTRIES`` and a wrapper that calls :func:`call`. What the wrappers share
lives here too: the planes' dtypes, the grid's limits, the band of the
exact-sigmoid kernels and :func:`check_on`.
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

import torch

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


PLANE_DTYPES = (torch.float32, torch.bfloat16)   # the lattice kernels' spin planes
MAX_BATCH = 65535          # lattices or replicas a batched launch: the grid's z extent
MAX_ROWS = 8 * 65535       # K3's grid (8 rows a block, gridDim.y <= 65535); the bond
                           # kernels' grid (4 strips of >= 8 rows a block) holds 4x more
CONTINUOUS_BAND = 1e-6     # |u - p| within which two right exp-based kernels may disagree


def check_on(device, **tensors):
    """Raise unless each tensor given (None is skipped) is contiguous on
    ``device``."""
    for name, t in tensors.items():
        if t is not None and (t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {device}")


_PLAIN = frozenset((int, float, bool, type(None)))   # arguments that pass as they are


class Stream(ctypes.c_void_p):
    """The cudaStream_t that ends a launch entry's arguments; :func:`call`
    supplies it."""


P, I, U, F, D, L, S = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                       ctypes.c_double, ctypes.c_longlong, Stream)
IP = ctypes.POINTER(ctypes.c_int)

# The C entries of each library and their argument types, in the order of
# the extern "C" declarations of csrc/<library>.cu. Every entry returns its
# CUDA error code, 0 on success.
ENTRIES = {
    "checkerboard_fused": {
        "tsu_fused_sweep": (P, P, P, P, P, I, I, I, U, U, I, S),
        "tsu_fused_sweep_shard": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, U, U, I, S),
        "tsu_fused_sweep_batched": (P, P, P, P, P, P, I, I, I, I, I, S),
        "tsu_decomposition_sweep": (I, P, P, P, P, I, I, I, U, U, I, S),
    },
    "checkerboard_bonds": {
        "tsu_bond_halfsweep": (P, P, P, P, P, P, P, I, I, F, P, P, I, I, I, I, U, U, S),
        "tsu_bond_halfsweep_batched": (P, P, P, P, P, P, P, I, I, P, P, P, P, I, I, I, I, I, S),
    },
    "checkerboard_halfsweep": {
        "tsu_halfsweep": (P, P, P, P, P, P, L, L, P, I, I, I, I, F, F, F, I, I, U, U, I, S),
    },
    "checkerboard_halfsweep_scalar": {   # K3's first body, which tests hold K3 against
        "tsu_halfsweep_scalar": (P, P, P, P, P, P, P, I, I, I, I, F, F, F, I, I, U, U, I, S),
    },
    "checkerboard_resident": {
        "tsu_resident_limits": (IP, IP, IP),
        "tsu_resident_occupancy": (I, I, IP),
        "tsu_resident_run": (P, P, P, I, P, I, I, I, I, U, I, I, I, I, I, P, P, S),
    },
    "houdayer_cluster": {
        "tsu_houdayer_cluster": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P, P, S),
        "tsu_houdayer_smem_limit": (IP,),
    },
    "dense_colour_sweep": {
        "tsu_dense_colour_sweep": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, L, S),
        "tsu_dense_colour_sweep_blocks_per_sm": (I, I, L, IP),
    },
    "plane_observables": {
        "tsu_plane_observables": (P, P, P, P, P, I, I, I, I, I, I, I, D, D, S),
        "tsu_plane_sums": (P, P, P, P, P, P, I, I, I, I, I, I, S),
    },
    "lattice_draw": {
        "tsu_lattice_draw": (P, P, I, I, I, I, U, U, I, S),
    },
}


def load(name: str, path) -> ctypes.CDLL:
    """Load the build at ``path`` of a version of library ``name``'s source
    and declare the C entries ``ENTRIES`` gives that library."""
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Library ``name`` (a key of ``ENTRIES``), built from csrc/<name>.cu
    and loaded once per process."""
    return load(name, library_path(name, (f"{name}.cu",)))


def cuda_index(device) -> int:
    """The index of CUDA ``device`` (a torch.device or its name): its own,
    or the current device's where it names none."""
    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def call(entry, device, *args, stream=None) -> None:
    """Run the C entry ``entry`` (an attribute of a :func:`library`) for CUDA
    ``device`` (a torch.device, its name or its index) under its device
    guard. Tensors among ``args`` pass as their data pointers and None as
    NULL. An entry whose last argument is a :class:`Stream` gets ``stream``
    there, a ``cuda_stream`` handle a loop looked up once, or else the
    device's current stream. Raises RuntimeError naming the entry and the
    CUDA error on a nonzero return."""
    args = [a if type(a) in _PLAIN or not isinstance(a, torch.Tensor) else a.data_ptr()
            for a in args]
    index = device if isinstance(device, int) else cuda_index(device)
    # A launch's host time matters on the host-bound paths: the guard of an
    # index costs a fraction of the guard of a torch.device, and the current
    # stream's raw handle, which torch's own generated code reads, a fraction
    # of torch.cuda.current_stream(), which builds a Stream object a call.
    with torch.cuda.device(index):
        if entry.argtypes[-1] is Stream:
            args.append(torch._C._cuda_getCurrentRawStream(index) if stream is None else stream)
        err = entry(*args)
    if err:
        raise RuntimeError(f"{entry.__name__} failed with CUDA error {err}")
