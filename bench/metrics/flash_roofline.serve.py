"""The flash kernel's share of its roofline: the bound ms of the calls'
work (``roofline.flash_call_ms``) over the device ms under the range
around ``kernels.ops.flash_attention``, in the profiled rounds."""
from bench import roofline


def read(trace, ctx):
    ms = trace["ranges_ms"].get("bench.kernel.flash", 0.0)
    if not trace["flash_calls"] or ms <= 0:
        return None
    return 100.0 * sum(roofline.flash_call_ms(c) for c in trace["flash_calls"]) / ms
