"""The share of a steady step in which no operation runs on the card:
the profiled steps' device-busy time (the union of the trace's operations)
over the median wall of the window's steady steps that were not profiled
(``harness.idle_share``)."""
from bench import harness


def read(trace, ctx):
    return harness.idle_share(trace, trace["steps"])
