"""mfu: the whole scoring step's share of the card's bf16 peak (989
TFLOP/s), in %: the model's FLOPs from its published shapes
(``workcounts.model_flops``) times the images scored in the measured
window, over the window's host-clock seconds."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
