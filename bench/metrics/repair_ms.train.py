"""Host ms the fault pipeline takes in the window's repair step: its drains
(``pipeline.drain``: detect, notice, agree, plan, apply) under that step's
``train.step`` span, read from the program's own spans."""
from bench import program_spans


def read(trace, ctx):
    return program_spans.repair_ms(trace, ctx)
