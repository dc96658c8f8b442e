"""Host ms a steady step waits for the card: the program's ``train.sync``
span, the step's first read of a device value (its loss), the median over
the window's steady steps. Large where the card paces the step."""
from bench import program_spans


def read(trace, ctx):
    return program_spans.median_steady(trace, ctx, "train.sync")
