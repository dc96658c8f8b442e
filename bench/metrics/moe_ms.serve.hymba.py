"""``moe_ms.serve`` in the cells that report ``serve_tokens_per_s.hymba``: the same
reading, moving that metric."""
from bench import harness

read = harness.metric_reader("moe_ms.serve").read
