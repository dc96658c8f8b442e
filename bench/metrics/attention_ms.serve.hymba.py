"""``attention_ms.serve`` in the cells that report ``serve_tokens_per_s.hymba``: the
same reading, moving that metric."""
from bench import harness

read = harness.metric_reader("attention_ms.serve").read
