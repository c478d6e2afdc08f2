"""idle_share: the share of the time in which nothing ran on the device
over the measured window, in %: 1 - the device's busy time an image in the
profiler's trace (the union of kernel, copy and memset intervals) times the
window's images over the window's seconds."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
