"""The ctypes argument types of every C entry point of the kernel library
(``ops/_build.py ENTRY_POINTS``) against its definition in
``lumfuncmcmc_tpu_torch/csrc/``: as many arguments, each a pointer where
the source's is one, and an ``int``, a ``long long`` or a ``double`` where
the source's is. A mismatch builds and loads; it shows only on the card,
as wrong memory."""

import ctypes
import pathlib
import re

import pytest

from lumfuncmcmc_tpu_torch.ops import _build

CSRC = pathlib.Path(_build.SRC_DIR)


def _signature(name):
    """The argument list of C function ``name`` in ``csrc/*.cu``."""
    for path in sorted(CSRC.glob("*.cu")):
        m = re.search(rf"^(?:int|cudaError_t)\s+{name}\s*\(([^)]*)\)",
                      path.read_text(), re.M)
        if m:
            return [a.strip() for a in m.group(1).split(",")]
    raise AssertionError(f"{name} is defined in no csrc/*.cu")


SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "double": ctypes.c_double}


def _kind(arg):
    if "*" in arg:
        return ctypes.c_void_p
    m = re.match(r"(int|long long|double)\s+\w+$", arg)
    assert m, arg
    return SCALARS[m.group(1)]


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_entry_point_argtypes_are_the_sources(name):
    assert [_kind(a) for a in _signature(name)] == _build.ENTRY_POINTS[name]
