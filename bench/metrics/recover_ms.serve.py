"""Time to recover in serving: the wall of the window's round that carried
the repair, less the median wall of the steady rounds after it that were
not profiled (host clock around ``ServeEngine.run_round``)."""
from bench import harness


def read(trace, ctx):
    return harness.recover_ms(trace, trace.get("rounds"))
