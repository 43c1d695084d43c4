"""The card's idle share of the traced slice of a stretch cell: 100 x (1 -
the union of device-operation intervals / the slice)."""

from portbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
