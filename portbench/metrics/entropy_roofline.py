"""entropy_roofline: the MC entropy stage's share of its roofline, in %,
over the traced stretch. The bound is counted from shapes, so either route
reads against the same work (``workcounts.entropy_stage``; linear in the
images, so the stretch's images give it whatever the batches); the time is
that of the stage's kernels in the profiler's trace: kernel 2 (the fused
route) alone, or kernel 1 (the default route) with the kernels that feed it
just before it: the tap's cast to f32, the keep-weights product and its
division by H*W."""

from portbench import readers, workcounts

FUSED = (r"fused_mc_entropy_kernel",)
TWO_STEP = (r"marginal_entropy_kernel",)
TWO_STEP_LEADS = (r"direct_copy_kernel", r"gemm", r"MulFunctor")


def read(ctx):
    bound = workcounts.entropy_stage(ctx.cfg, ctx.trace.images)["bound_s"]
    seconds = readers.stage_seconds(ctx, FUSED, ()) + readers.stage_seconds(ctx, TWO_STEP, TWO_STEP_LEADS)
    return readers.roofline_share(bound, seconds)
