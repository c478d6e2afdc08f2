"""program_idle_share: the share, in %, of the device's idle time over the
profiler's traced stretch during which the host's main thread was inside
one of the program's ``runia.*`` spans (each idle gap put down to the span
running when it began). The rest is the client's: its load generator, its
frame choice, its copies to the host."""

from portbench import spans


def read(ctx):
    return spans.program_idle_share(ctx)
