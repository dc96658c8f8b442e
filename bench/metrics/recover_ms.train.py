"""Time to recover in training: the wall of the window's step that carried
the repair, less the median wall of the steady steps after it that were
not profiled (host clock around ``run_step``, the card synchronised)."""
from bench import harness


def read(trace, ctx):
    return harness.recover_ms(trace, trace.get("steps"))
