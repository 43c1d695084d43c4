"""Native (C) components: the data-loader tier (the port's own copy of
``lumfuncmcmc_tpu/native``, so the port imports nothing of the JAX
package).

The reference is pure Python (SURVEY.md §0: no native code anywhere);
its catalog ingest goes through astropy's Python ascii reader
(``run_lumfuncmcmc.py:165``). For production-scale catalogs the parse
dominates host time, so this package carries a C parser
(``fastread.c``) compiled on demand with the system toolchain and bound
via ctypes (pybind11 is not available in this environment). Everything
degrades gracefully: if no C compiler is present or compilation fails,
callers fall back to the pure-Python reader.

``read_table_fast(path)`` returns the same dict-of-columns the Python
``read_ascii_table`` produces (float64 arrays for numeric columns,
object arrays of strings otherwise) or ``None`` when the native path is
unavailable or declines the file (e.g. mixed-type columns).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fastread.c")
_lib = None
_lib_failed = False


def _build_lib() -> Optional[ctypes.CDLL]:
    """Compile fastread.c into a cached shared object and load it."""
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    cache_dir = os.environ.get(
        "LUMFUNC_NATIVE_CACHE",
        os.path.join(tempfile.gettempdir(), "lumfuncmcmc_tpu_torch_native"))
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"fastread_{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["cc", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, OSError, FileNotFoundError):
            return None
    lib = ctypes.CDLL(so_path)
    lib.ft_parse.restype = ctypes.c_void_p
    lib.ft_parse.argtypes = [ctypes.c_char_p]
    lib.ft_error.restype = ctypes.c_char_p
    lib.ft_error.argtypes = [ctypes.c_void_p]
    lib.ft_ncols.restype = ctypes.c_int
    lib.ft_ncols.argtypes = [ctypes.c_void_p]
    lib.ft_nrows.restype = ctypes.c_int64
    lib.ft_nrows.argtypes = [ctypes.c_void_p]
    lib.ft_col_name.restype = ctypes.c_char_p
    lib.ft_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ft_col_is_numeric.restype = ctypes.c_int
    lib.ft_col_is_numeric.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ft_col_values.restype = None
    lib.ft_col_values.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_double)]
    lib.ft_col_codes.restype = None
    lib.ft_col_codes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int32)]
    lib.ft_col_nuniq.restype = ctypes.c_int
    lib.ft_col_nuniq.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ft_col_uniq.restype = ctypes.c_char_p
    lib.ft_col_uniq.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int]
    lib.ft_free.restype = None
    lib.ft_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is None and not _lib_failed:
        _lib = _build_lib()
        _lib_failed = _lib is None
    return _lib


def read_table_fast(path: str) -> Optional[dict]:
    """Parse a plain whitespace table with the C reader.

    Returns the read_ascii_table-compatible dict, or None when the
    native library is unavailable or the file needs the Python reader
    (mixed-type columns, fixed-width layouts, ...).
    """
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.ft_parse(os.fsencode(path))
    if not handle:
        return None
    try:
        if lib.ft_error(handle):
            return None
        nrows = int(lib.ft_nrows(handle))
        if nrows == 0:
            # header-only file: column types are undecided (the C side
            # never allocated value buffers) — let the Python reader
            # define the empty-table semantics
            return None
        out = {}
        for i in range(int(lib.ft_ncols(handle))):
            name = lib.ft_col_name(handle, i).decode()
            if lib.ft_col_is_numeric(handle, i):
                vals = np.empty(nrows, dtype=np.float64)
                lib.ft_col_values(
                    handle, i,
                    vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
                out[name] = vals
            else:
                codes = np.empty(nrows, dtype=np.int32)
                lib.ft_col_codes(
                    handle, i,
                    codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                uniq = np.asarray(
                    [lib.ft_col_uniq(handle, i, j).decode()
                     for j in range(int(lib.ft_col_nuniq(handle, i)))])
                out[name] = uniq[codes]
        return out
    finally:
        lib.ft_free(handle)
