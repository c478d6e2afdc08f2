"""loader_wait_ms: ms a ``score_dataset`` call's main thread spent blocked
on the loader (the program's ``runia.loader.wait`` spans summed per call),
the median over the calls of the recorded stretches (``spans.MIN_CALLS``
calls at least) run without the profiler; host clock. It is the loader's lag
behind the consumer, which submits a call's first batches as fast as they
come: most of the wait falls while batches already submitted keep the card
busy, so it costs ``img_per_s`` only where it outlasts them. The device
idle that begins inside the wait is ``program_idle_share``'s
``runia.loader.wait`` part."""

from portbench import spans


def read(ctx):
    rec = spans.recorded(ctx)
    return None if rec is None else spans.per_root_ms(rec, "runia.loader.wait", "runia.service.score_dataset")
