"""Family ``affine`` of the new-cell test: the plain reference, in float64."""

import torch


def forward(weights, rows, cfg, quantize=None):
    q = quantize or (lambda t, is_weight: t)
    x = rows.double()
    for i in range(cfg["layers"]):
        x = torch.tanh(q(x, False).double() @ q(weights[f"layer{i}"], True).double())
    return x
