"""Device ms a traced round of the Mamba-2 mixers: the operations launched
under the program's ``model.ssd`` regions (the projections, the conv, the
SSD scan, the decode step's state update), prefill and decode
(``harness.region_ms``)."""
from bench import harness


def read(trace, ctx):
    return harness.region_ms(trace, "model.ssd")
