"""Host ms a round spends outside the model, from the program's own spans:
the ``serve.round`` span less its ``serve.work`` children (each ends by
copying its tokens to the host), the median over the window's steady
rounds. The inside twin of ``engine_host_ms.serve``."""
import statistics

from bench import program_spans


def read(trace, ctx):
    spans = program_spans.window(trace, ctx)
    if spans is None:
        return None
    host = [spans[i][0].ms - program_spans.ms_under(spans[i], "serve.work")
            for i in program_spans.steady(trace, spans)]
    return statistics.median(host) if host else None
