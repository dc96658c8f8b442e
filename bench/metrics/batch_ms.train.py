"""Host ms a steady step spends building its batch (the program's
``train.batch`` span around the trainer's ``_batch_of``), the median over
the window's steady steps."""
from bench import program_spans


def read(trace, ctx):
    return program_spans.median_steady(trace, ctx, "train.batch")
