"""replay_ms: device ms of one scorer call at the cell's batch (one
dataset batch, or one request's frame): ``build_larex_scorer``'s
CUDA-graph replay with a new generator a call, by CUDA events around 20
calls after 3."""

from portbench import readers


def read(ctx):
    return readers.replay_ms(ctx)
