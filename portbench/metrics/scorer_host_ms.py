"""scorer_host_ms: mean host ms of one scorer call (the program's
``runia.scorer.call`` span: the generator's state lent, the input copied in,
the graph launched, the outputs cloned), over the recorded stretches run
without the profiler (``spans.recorded``); host clock. Beside ``replay_ms`` it is the program's
own host time a batch or request."""

from portbench import spans


def read(ctx):
    rec = spans.recorded(ctx)
    return None if rec is None else spans.mean_ms(rec, "runia.scorer.call")
