"""Feature taps for any PyTorch module, by forward hook.

Counterpart of ``runia_core_tpu/extraction/taps.py``. The JAX package reads
a flax module's intermediates; a torch module is tapped with
``register_forward_hook`` on the submodules a caller selects. The hooks are
registered for one call and removed after it, and the tapped forward
returns what they caught, so the taps are outputs of the call and not state
left behind: a CUDA graph can capture the function, and its replays return
the taps in the graph's static outputs.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Union

import torch
from torch import nn

from runia_core_tpu_torch import default_device

__all__ = ["Hook", "apply_dropout", "tap_torch_model"]

_DROPOUTS = (nn.Dropout, nn.Dropout1d, nn.Dropout2d, nn.Dropout3d, nn.AlphaDropout, nn.FeatureAlphaDropout)


def apply_dropout(module: nn.Module) -> nn.Module:
    """Put every dropout submodule of ``module`` (``nn.Dropout*``,
    ``nn.AlphaDropout``, ``nn.FeatureAlphaDropout``) into train mode, the
    rest untouched, and return the module: MC dropout at inference, as the
    reference's helper does to its torch layers. The JAX package's
    ``apply_dropout`` is a no-op standing in for this effect, because flax
    has no global train/eval mode (dropout runs when it is given a key);
    a torch module has one, so here the switch is real."""
    for sub in module.modules():
        if isinstance(sub, _DROPOUTS):
            sub.train()
    return module


def tap_torch_model(
    module: nn.Module,
    capture: Union[Sequence[str], Callable[[nn.Module, str], bool]],
    tap_aliases: Dict[str, str] = None,
    device=None,
    **call_kwargs,
) -> Callable:
    """Build a tapped forward from any ``nn.Module``.

    Args:
        module: the model; it is called as ``module(images, **call_kwargs)``.
        capture: substrings of the ``named_modules()`` names to tap (e.g.
            ``("stage4_block2", "head")``), or a filter
            ``(submodule, name) -> bool``.
        tap_aliases: {alias: name substring}: the first tap (in
            ``named_modules()`` order) whose name holds the substring is
            also returned under the alias, e.g. ``{"pre_pool": "stage4"}``.
        device: where the images are moved before the call (None: the GPU,
            ``runia_core_tpu_torch.default_device()``).

    Returns:
        ``images -> (outputs, {tap name: output})`` under
        ``torch.inference_mode``. A submodule called twice in one forward
        gives its last output. Taps are the submodules' outputs as they are
        (the port's ResNet blocks give NCHW maps).
    """
    if callable(capture) and not isinstance(capture, (list, tuple)):
        selected = capture
    else:
        substrings = tuple(capture)

        def selected(sub: nn.Module, name: str) -> bool:
            return any(s in name for s in substrings)

    tapped = [(name, sub) for name, sub in module.named_modules() if selected(sub, name)]
    aliases = dict(tap_aliases or {})
    device = default_device() if device is None else torch.device(device)

    @torch.inference_mode()
    def forward(images):
        caught: Dict[str, object] = {}

        def hook_for(name):
            def hook(sub, inputs, output):
                caught[name] = output  # a second call of the submodule replaces the first
            return hook

        handles = [sub.register_forward_hook(hook_for(name)) for name, sub in tapped]
        try:
            outputs = module(torch.as_tensor(images, device=device), **call_kwargs)
        finally:
            for handle in handles:
                handle.remove()
        taps = {name: caught[name] for name, _ in tapped if name in caught}
        for alias, substring in aliases.items():
            for name, value in list(taps.items()):
                if substring in name:
                    taps[alias] = value
                    break
        return outputs, taps

    return forward


def _copy(value):
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, (tuple, list)):
        return type(value)(_copy(v) for v in value)
    return value


class Hook:
    """A reference-style holder of one tap's output.

    Construct it with a tap name and call ``hook.capture(taps)`` after a
    tapped forward to fill ``hook.output``. The output is a copy: the taps
    of a CUDA-graph replay live in the graph's static buffers, which the
    next replay overwrites.
    """

    def __init__(self, tap_name: str, backward: bool = False):
        if backward:
            raise ValueError("backward hooks have no functional equivalent")
        self.tap_name = tap_name
        self.input = None
        self.output = None

    def capture(self, taps: Dict[str, torch.Tensor]) -> "Hook":
        self.output = _copy(taps[self.tap_name])
        return self

    def close(self) -> None:
        self.input = None
        self.output = None
