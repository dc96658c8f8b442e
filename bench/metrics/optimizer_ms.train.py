"""Device ms a step of the optimizer: the kernels launched inside the
ranges put around ``clip_by_global_norm_`` and ``adamw_update_``, over the
profiled steps."""


def read(trace, ctx):
    lo, hi = trace["traced"]
    ms = trace["ranges_ms"].get("bench.train.optimizer", 0.0)
    return ms / (hi - lo) if ms > 0 else None
