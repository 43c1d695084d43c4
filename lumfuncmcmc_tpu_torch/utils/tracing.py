"""Stage spans of the port, on a torch profiler's clock.

``span(name)`` opens an ``lf.<name>`` event while a torch profiler is
recording (``--profile DIR``, or a profiler the caller runs) and is one
shared context that does nothing otherwise: the profiler is the switch.
A span does no device work, no host sync and no tensor allocation.

The event is a function-scope record (``_RecordFunctionFast``), not a
``record_function`` user annotation: a user annotation also leaves a
device-side copy of itself over the kernels it encloses, which a reader
of the trace's device timeline would take for device work.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "lf."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context around one stage of the port's work: the event
    ``lf.<name>`` while a profiler records, else a no-op."""
    # read at each call: a profiler starts and stops at run time
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF
