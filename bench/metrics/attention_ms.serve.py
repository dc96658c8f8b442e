"""Device ms a traced round of the attention mixers: the operations
launched under the program's ``model.attention`` regions (projections,
rope, the cache writes, flash or the decode attention), prefill and decode
(``harness.region_ms``)."""
from bench import harness


def read(trace, ctx):
    return harness.region_ms(trace, "model.attention")
