"""mfu.complete: the serving step's share of the card's bf16 peak (989
TFLOP/s), in %: the model FLOPs of the prompts and answers of the requests
that ended inside the measured window (2 a weight a token for the active
parameters, 4 a (query, key) pair a dimension of each query head, from the
published shapes: ``reference/mellum_work.sequence_flops``), over the
window's host-clock seconds."""

from portbench import workcounts
from portbench.reference import mellum_work


def read(ctx):
    results = [r for r in ctx.load.results if r["ended"]]
    if not results:
        return None
    flops = sum(mellum_work.sequence_flops(ctx.cfg, len(ctx.load.pool[r["index"]]) + len(r["tokens"]))
                for r in results)
    return 100.0 * flops / ctx.window["seconds"] / workcounts.PEAK_BF16_FLOPS
