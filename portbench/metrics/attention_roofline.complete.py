"""attention_roofline.complete: kernel 4's share of its roofline over a
traced stretch, in %: its bound over the device time of its launches
(``flash_mma_kernel``, the bf16 kernel the cell runs). The bound is the
larger of the (query, key) pairs that each layer's kind attends, causal on
full layers and in the window on sliding ones, x 4 x query heads x head
dimension at 989 TFLOP/s, and the bytes of q and the output of every query
and of k and v of the keys each row attends, at 3.35 TB/s
(``reference/mellum_work.attention_work``). The kernel counts the pairs,
keys and queries on the device (``flash_prefix_attention.work``), so tiles
it skips are no work."""

from portbench import engine_trace, readers, workcounts
from portbench.reference import mellum_work


def read(ctx):
    trace = engine_trace.stretch(ctx)
    counts = trace.work.get("flash_prefix_attention")
    seconds = sum(s for name, s in trace.kernels if "flash_mma_kernel" in name)
    if not counts or not seconds:
        return None
    work = mellum_work.attention_work(ctx.cfg, *counts)
    bound = workcounts.roofline_s(work["bytes"], work["flops"], workcounts.PEAK_BF16_FLOPS)["bound_s"]
    return readers.roofline_share(bound, seconds)
