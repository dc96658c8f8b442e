"""Host ms a round spends outside the model: a round's wall less its
work calls (each ends by copying its tokens to the host), the median over
the window's steady rounds that were not profiled."""
from bench import harness


def read(trace, ctx):
    lo, hi = trace["traced"]
    r = trace["repair_at"]
    host = [(x["wall_s"] - x["work_s"]) * 1e3 for i, x in enumerate(trace["rounds"])
            if i != r and not lo <= i < hi]
    return harness.median(host)
