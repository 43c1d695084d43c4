"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library goes to ``lumfuncmcmc_tpu_torch/_build/``
under a name keyed on a hash of the sources and flags, at first use;
the repository's sources are all a build needs.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--threads", "0")     # the .cu sources compile side by side

_p, _i = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes; each returns the cudaError_t of its launches
# (or, for the occupancy query, of the query)
# the one-launch kernels (each value kernel takes its value+gradient twin's
# arguments): piece and segment tables, walker tile (then fcmin, or the z
# bands' row phases), then the partials, the tickets and the rows
_VG_TAIL = [_p, _i, _p, _i, _i]
_FREE_VG_ARGS = [_p, _i, _i, _i] + [_p] * 11 + _VG_TAIL + [_i, _p, _p, _p, _p]
_FIXED_VG_ARGS = [_p, _i, _i] + [_p] * 3 + _VG_TAIL + [_p, _p, _p, _p]
_Z_VG_ARGS = [_p, _i, _i, _i, _i] + [_p] * 10 + _VG_TAIL + [_i, _p, _p, _p, _p]
_HIER_VG_ARGS = [_p, _i, _i, _i] + [_p] * 3 + _VG_TAIL + [_p, _p, _p, _p]
_STREAM_ARGS = ([_p, _i, _i, _i] + [_p] * 8
                + [_p, _i, _i, _i, _i, _p, _p, _p])
ENTRY_POINTS = {"free_lnlike_launch": _FREE_VG_ARGS,
                "fixed_lnlike_launch": _FIXED_VG_ARGS,
                "free_lnlike_vg_launch": _FREE_VG_ARGS,
                "fixed_lnlike_vg_launch": _FIXED_VG_ARGS,
                "z_lnlike_launch": _Z_VG_ARGS,
                "z_lnlike_vg_launch": _Z_VG_ARGS,
                "hier_lnlike_launch": _HIER_VG_ARGS,
                "hier_lnlike_vg_launch": _HIER_VG_ARGS,
                "free_stream_lnlike_launch": _STREAM_ARGS,
                "free_stream_lnlike_vg_launch": _STREAM_ARGS,
                "free_stream_blocks_per_sm": [_i, _i, _p],
                "roofline_chain_launch": [_p, _p, _i, _i, _p],
                "roofline_chain_layout": [_i, _p],
                "empty_launch": [_i, _p]}

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output (ptxas register/spill report)
build_seconds = 0.0     # 0.0 when the library was already built


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def find_nvcc() -> str:
    """``nvcc`` from CUDA_HOME, /usr/local/cuda or the PATH."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return nvcc


def build() -> str:
    """Compile the kernels if this source hash has no library yet;
    returns the library path."""
    global build_log, build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    so_path = os.path.join(BUILD_DIR, f"liblnlike_{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[p for p in _sources() if p.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so_path)
    return so_path


def build_on_grid(grid) -> None:
    """Build once for a grid of ranks: the grid's rank 0 (``LOCAL_RANK``
    0 on each node of a torchrun launch) runs ``nvcc`` while the grid's
    other ranks wait at a barrier, then every rank loads the library (a
    rank on a node whose disk holds no build builds its own). A
    COLLECTIVE over ``grid.group``."""
    from lumfuncmcmc_tpu_torch.parallel.distributed import barrier
    leader = (int(os.environ["LOCAL_RANK"]) == 0
              if "LOCAL_RANK" in os.environ else grid.rank == 0)
    err = None
    if leader:
        try:
            build()
        except Exception as e:      # the others must not wait for it
            err = e
    barrier(grid.group)
    if err is not None:
        raise err
    load_library()


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every
    entry point's argument types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn, argtypes in ENTRY_POINTS.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _i
            _lib = lib
        return _lib
