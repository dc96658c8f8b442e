"""Device ms a traced round of the dense MLPs: the operations launched under
the program's ``model.mlp`` regions, prefill and decode
(``harness.region_ms``)."""
from bench import harness


def read(trace, ctx):
    return harness.region_ms(trace, "model.mlp")
