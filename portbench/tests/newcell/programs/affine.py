"""Program ``affine`` of the new-cell test: a stack of tanh layers over
seeded rows, judged by the largest gap to the reference's rows."""

import importlib
from types import SimpleNamespace

import torch

from portbench import inputs
from portbench.reference import affine as reference
from portbench.reference.precision import CONTROLS

CHECKS = ("gap",)
COMPARE = ("scale",)


def make_inputs(cfg, traffic, seed, device):
    g = inputs.generator(device, seed, inputs.TAGS["weights"])
    f = cfg["features"]
    return {"weights": {f"layer{i}": torch.randn(f, f, generator=g, device=device) / f**0.5
                        for i in range(cfg["layers"])},
            "rows": torch.randn(traffic["rows"], f, generator=g, device=device)}


def build(cfg, traffic, seed, made, device):
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    return SimpleNamespace(forward=family.build_forward(cfg, made["weights"], device), rows=made["rows"])


def checked_state(program):
    return None


def release(program):
    program.forward = None


def judge(cfg, traffic, seed, made, blocks, state, device, compared, controls=(), record=False):
    want = reference.forward(made["weights"], made["rows"], cfg)

    def gap(answers):
        return max(float((a.double() - want).abs().max() / want.abs().max()) for a in answers) * compared["scale"]

    return {"numbers": {"gap": gap(blocks)},
            "controls": {c: {"gap": gap([reference.forward(made["weights"], made["rows"], cfg, CONTROLS[c])])}
                         for c in controls}}
