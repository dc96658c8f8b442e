"""The SSD scan kernel's share of its roofline: the bound ms of the calls'
work (``roofline.ssd_call_ms``) over the device ms under the range around
``kernels.ops.ssd_scan``, in the profiled rounds."""
from bench import roofline


def read(trace, ctx):
    ms = trace["ranges_ms"].get("bench.kernel.ssd", 0.0)
    if not trace["ssd_calls"] or ms <= 0:
        return None
    return 100.0 * sum(roofline.ssd_call_ms(c) for c in trace["ssd_calls"]) / ms
