"""``mfu.serve`` in the cells that report ``serve_tokens_per_s.hymba`` and
``serve_p95_s.hymba``: the same reading, moving those metrics."""
from bench import harness

read = harness.metric_reader("mfu.serve").read
