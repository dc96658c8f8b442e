"""Host ms a steady round waits for the card: the program's ``serve.sync``
spans (each batch's tokens copied to the host), summed over the round's
batches, the median over the window's steady rounds. Large where the card
paces the round, small where the host does."""
from bench import program_spans


def read(trace, ctx):
    return program_spans.median_steady(trace, ctx, "serve.sync")
