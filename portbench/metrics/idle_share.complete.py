"""idle_share.complete: the share, in %, of the closed loop's traced
seconds in which nothing ran on the device (the union of kernel, copy and
memset intervals): the first ``trace_seconds`` of the traced stretch, while
every client has a request in; the drain after it, with fewer and fewer
requests, is left out. Read on the traced stretch itself, since a
request's device work follows its prompt's length and the window's request
count cannot scale it; the profiler slows the host, so it reads high where
the host sets the pace."""


def read(ctx):
    horizon = min(float(ctx.traffic["trace_seconds"]), ctx.trace.window_s)
    busy = sum(min(end, horizon) - start for start, end in ctx.trace.busy_intervals() if start < horizon)
    return 100.0 * (1.0 - busy / horizon)
