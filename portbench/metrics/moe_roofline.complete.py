"""moe_roofline.complete: the grouped expert kernel's share of its
roofline over a traced stretch, in %: its bound over the device time of its
launches (``moe_grouped_kernel``). The bound is the larger of the stretch's
pairs x 6 x d x I operations at 989 TFLOP/s and the bytes of the experts
that got a pair, summed over the launches, with each pair's row in and out,
at 3.35 TB/s (``reference/mellum_work.experts_work``); the kernel counts
the pairs and touched experts on the device (``moe_grouped.work``), read
after the stretch. Every launch of the cell is bound by its experts'
bytes, so the larger of the sums is the sum of each launch's bound."""

from portbench import engine_trace, readers, workcounts
from portbench.reference import mellum_work


def read(ctx):
    trace = engine_trace.stretch(ctx)
    counts = trace.work.get("moe_grouped")
    seconds = sum(s for name, s in trace.kernels if "moe_grouped_kernel" in name)
    if not counts or not seconds:
        return None
    work = mellum_work.experts_work(ctx.cfg, counts[0], counts[1])
    bound = workcounts.roofline_s(work["bytes"], work["flops"], workcounts.PEAK_BF16_FLOPS)["bound_s"]
    return readers.roofline_share(bound, seconds)
