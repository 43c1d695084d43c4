"""``free_lnlike``'s share of its roofline in the traced slice (kernel name
patterns: ``kernel_names/free_lnlike*.json``; counts: ``counts/free.py``)."""

from portbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "free_lnlike")
