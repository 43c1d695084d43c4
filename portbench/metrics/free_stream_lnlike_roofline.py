"""``free_stream_lnlike``'s share of its roofline in the traced slice: its
two launches a call, ``stream_partials`` and ``stream_finish``, as one
call (kernel name patterns: ``kernel_names/free_stream_lnlike*.json``;
counts: ``counts/free.py``)."""

from portbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "free_stream_lnlike")
