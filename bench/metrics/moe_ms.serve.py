"""Device ms a traced round of the MoE layers: the operations launched under
the program's ``model.moe.*`` regions (route, dispatch, the expert GEMMs,
combine, the shared expert), prefill and decode (``harness.region_ms``)."""
from bench import harness


def read(trace, ctx):
    return harness.region_ms(trace, "model.moe")
