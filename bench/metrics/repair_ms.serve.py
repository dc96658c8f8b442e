"""Host ms the fault pipeline takes in the window's repair round: its
drains (``pipeline.drain``: detect to apply, and the listener that
redelivers the failed node's requests) under that round's ``serve.round``
span, read from the program's own spans."""
from bench import program_spans


def read(trace, ctx):
    return program_spans.repair_ms(trace, ctx)
