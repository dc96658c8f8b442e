"""``engine_ms.serve`` in the cells that report ``serve_p95_s.hymba``: the same
reading, moving that metric."""
from bench import harness

read = harness.metric_reader("engine_ms.serve").read
