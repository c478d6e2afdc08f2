"""Family ``affine`` of the new-cell test: the program's forward."""

import torch


def build_forward(cfg, weights, device):
    dtype = getattr(torch, cfg["dtype"])
    layers = [weights[f"layer{i}"].to(device, dtype) for i in range(cfg["layers"])]

    def forward(rows):
        x = rows.to(dtype)
        for w in layers:
            x = torch.tanh(x @ w)
        return x.float()

    return forward
