"""Model FLOPs of the batches (``bench/flops.py``: the prefill and the
decode steps whose logits give a served token) over the wall of the
window's steady rounds (neither the repair's nor the profiled ones), as a
share of the card's bf16 peak."""
from bench import harness, roofline


def read(trace, ctx):
    rate = harness.steady_rate(trace, trace["rounds"])
    return None if rate is None else 100.0 * rate / roofline.PEAK_BF16_FLOPS
