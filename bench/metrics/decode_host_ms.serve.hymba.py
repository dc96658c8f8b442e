"""Host ms of one steady decode step: the program's ``serve.decode`` span
around each ``api.decode_step`` call (the host issuing the step's kernels;
the card runs behind it), the median over the window's steady rounds. A
generation's first step (``index`` 0) is left out: it waits for room in
the launch queue while the card still runs the prefill, so it reads the
prefill's pace, not the host's."""
import statistics

from bench import program_spans


def read(trace, ctx):
    spans = program_spans.window(trace, ctx)
    if spans is None:
        return None
    steps = [r.ms for i in program_spans.steady(trace, spans) for r in spans[i][1]
             if r.name == "serve.decode" and r.attrs["index"] > 0]
    return statistics.median(steps) if steps else None
