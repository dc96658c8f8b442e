"""Device ms a step of the GEMMs with the vocabulary as a dimension: the
loss's fp32 logits, forward, recompute and backward, from the profiler's
operators and their shapes, over the profiled steps."""


def read(trace, ctx):
    lo, hi = trace["traced"]
    return trace["vocab_gemm_ms"] / (hi - lo) if trace["vocab_gemm_ms"] > 0 else None
