"""The program's ``lf.*`` spans in the traced slice: ``trace.reduce``
reads the same trace with or without them, and each span metric reads
the hand-computed value from a hand-made slice, or nothing where the
program has no spans."""

import os
import types

import pytest
import torch

from portbench.harness.cells import load_module
from portbench.harness.program_spans import program_spans, reduce_program
from portbench.harness.runner import RunRecord
from portbench.harness.trace import breakdown, reduce
from portbench.tests.tiny import REPO

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Event:
    """A raw profiler event as ``reduce`` reads one."""

    def __init__(self, name, start, dur, device=CPU):
        self._v = (name, start, dur, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


# one traced fit: the window, the sampler's loop of two steps of two
# lnprob calls each (one call for the starts), the device's kernels and
# launches, then the post-processing
BENCH = [
    Event("portbench.window", 0, 10_000),
    Event("portbench.sampler", 100, 8_000),
    Event("portbench.lnprob", 200, 1_000),
    Event("portbench.lnprob", 1_500, 1_000),
    Event("portbench.lnprob", 2_600, 1_000),
    Event("portbench.lnprob", 4_500, 1_000),
    Event("portbench.lnprob", 5_600, 1_000),
    Event("portbench.lnprob", 1_500, 1_000, CUDA),   # its device copy
    Event("cudaLaunchKernel", 300, 5),
    Event("cudaLaunchKernel", 1_900, 5),
    Event("cudaLaunchKernel", 3_300, 5),
    Event("void free_vg<4, 1>(float const*)", 1_950, 40, CUDA),
    Event("void free_vg<4, 1>(float const*)", 3_350, 40, CUDA),
    Event("aten::add", 3_000, 20),
    Event("void at::native::copy(float*)", 8_500, 300, CUDA),
]
# the program's own spans, host events only; the last step's first call
# has no kernel span, to read the self time apart from the counts
PROGRAM = [
    Event("lf.lnprob", 210, 900),
    Event("lf.features", 220, 500),
    Event("lf.kernel", 730, 100),
    Event("lf.step", 1_400, 2_400),
    Event("lf.lnprob", 1_510, 900),
    Event("lf.features", 1_520, 300),
    Event("lf.kernel", 1_850, 150),
    Event("lf.lnprob", 2_610, 900),
    Event("lf.features", 2_620, 400),
    Event("lf.kernel", 3_250, 200),
    Event("lf.step", 4_400, 2_400),
    Event("lf.lnprob", 4_510, 700),
    Event("lf.features", 4_520, 200),
    Event("lf.lnprob", 5_610, 800),
    Event("lf.features", 5_620, 300),
    Event("lf.kernel", 5_950, 50),
    Event("lf.post", 8_200, 1_500),
    Event("lf.post", 10_500, 200),         # after the window: not read
]


def _parts(trace):
    return (trace.ops, trace.launches.tolist(), trace.window,
            {k: trace.spans.get(k) for k in ("lnprob", "sampler", "window")},
            breakdown(trace, "post"))


def test_reduce_reads_the_same_with_and_without_program_spans():
    without = reduce(BENCH)
    mixed = BENCH[:5] + PROGRAM + BENCH[5:]
    assert _parts(reduce(mixed)) == _parts(without)
    assert without.busy_s() == reduce(mixed).busy_s()


def test_reduce_program_keeps_host_lf_events_under_full_names():
    got = reduce_program(BENCH + PROGRAM + [Event("lf.step", 0, 9, CUDA)])
    assert sorted(got) == ["lf.features", "lf.kernel", "lf.lnprob",
                           "lf.post", "lf.step"]
    assert got["lf.step"] == [(1_400, 3_800), (4_400, 6_800)]
    assert len(got["lf.lnprob"]) == 5


def _record(events):
    """A run record of a traced slice whose profiler holds ``events``."""
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return RunRecord(trace=reduce(events), window={},
                     log=types.SimpleNamespace(
                         tracer=types.SimpleNamespace(prof=prof)))


def _read(name, run):
    return load_module(os.path.join(REPO, "portbench", "metrics",
                                    name + ".py")).read(run)


def test_span_metrics_read_the_hand_computed_values():
    run = _record(BENCH + PROGRAM)
    # (500 + 300 + 400 + 200 + 300) / 5 ns
    assert _read("features_us", run) == pytest.approx(0.34)
    # (100 + 150 + 200 + 50) / 4 ns
    assert _read("kernel_host_us", run) == pytest.approx(0.125)
    # (2400 - 900 - 900) and (2400 - 700 - 800) ns, mean
    assert _read("step_self_us", run) == pytest.approx(0.75)
    # the window's post span alone
    assert _read("post_s", run) == pytest.approx(1.5e-6)
    assert set(program_spans(run)) == {"lf.features", "lf.kernel",
                                       "lf.lnprob", "lf.post", "lf.step"}


@pytest.mark.parametrize("name", ["features_us", "kernel_host_us",
                                  "step_self_us", "post_s"])
def test_span_metrics_read_nothing_without_program_spans(name):
    assert _read(name, _record(BENCH)) is None
    untraced = _record(BENCH)
    untraced.trace = None
    untraced.log.tracer.prof = None
    assert _read(name, untraced) is None


def test_traced_tiny_rehearsal_reports_the_span_metrics(tmp_path):
    """The whole traced run on the kernels' plain versions reads all
    four from the program's spans, and stays correct."""
    from portbench.tests.tiny import run_tiny, tiny_root
    traced = run_tiny(tiny_root(str(tmp_path)), "flagship.stretch",
                      seed=2 ** 31 + 23, trace=1)
    assert traced["correct"], traced["checks"]
    for name in ("features_us", "kernel_host_us", "step_self_us", "post_s"):
        assert traced["metrics"][name]["value"] > 0, name
