"""Training utilities for the port's model zoo.

Counterpart of ``runia_core_tpu/training.py``: train a tapped classifier,
then tap it, fit detectors and score in one stack. ``torch.optim`` takes
optax's place; the default, ``torch.optim.Adam(lr=1e-3)``, is optax's
``adam`` in its math (b1 0.9, b2 0.999, eps 1e-8 added outside the square
root of the bias-corrected second moment). A model with BatchNorm trains in
``train()`` mode, where the port's :class:`models.resnet.BatchNorm` is
flax's: batch statistics with the biased variance, running statistics moved
as ``0.9 * running + 0.1 * batch``, in place (flax returns them as new
``batch_stats``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from runia_core_tpu_torch.models.resnet import BatchNorm
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = ["TrainState", "create_train_state", "make_train_step", "fit_classifier"]

Optimizer = torch.optim.Optimizer


@dataclass
class TrainState:
    """What a step changes: the model (its parameters and BatchNorm running
    statistics, JAX's ``params`` and ``extra_variables``), the optimizer (its
    state, JAX's ``opt_state``) and the step count."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def _optimizer(model: nn.Module, tx, learning_rate: float) -> Optimizer:
    """``tx`` as an optimizer over the model's parameters: None is
    ``Adam(lr=learning_rate)``; an optimizer is used as it is; anything else
    is called with the parameters (``lambda p: torch.optim.SGD(p, lr=0.1)``)."""
    if tx is None:
        return torch.optim.Adam(model.parameters(), lr=learning_rate)
    if isinstance(tx, Optimizer):
        return tx
    return tx(model.parameters())


def create_train_state(
    model: nn.Module,
    generator: Optional[torch.Generator] = None,
    tx=None,
    learning_rate: float = 1e-3,
) -> Tuple[TrainState, Optimizer]:
    """A train state for ``model`` and its optimizer. With ``generator`` a
    model that has ``init_weights`` is initialised from it first (the
    port's models are built with their weights, so JAX's ``rng`` and
    ``sample_input`` are not needed)."""
    if generator is not None and hasattr(model, "init_weights"):
        model.init_weights(generator)
    optimizer = _optimizer(model, tx, learning_rate)
    return TrainState(model=model, optimizer=optimizer), optimizer


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels)


def _has_batch_norm(model: nn.Module) -> bool:
    return any(isinstance(m, (BatchNorm, nn.modules.batchnorm._BatchNorm)) for m in model.modules())


def make_train_step(
    model: nn.Module,
    tx: Optional[Optimizer] = None,
    loss_fn: Optional[Callable] = None,
    has_batch_stats: Optional[bool] = None,
    accum_steps: int = 1,
) -> Callable:
    """A cross-entropy train step for (logits, taps)-returning models:
    ``step(state, images, labels) -> (state, {"loss", "accuracy"})``.

    With BatchNorm (``has_batch_stats``; None: the model has one) the
    forward runs in ``train()`` mode and moves the running statistics;
    without it, in ``eval()`` mode (running statistics used and kept).
    ``tx`` is the optimizer to step (None: the state's).

    ``accum_steps > 1`` splits the batch into that many equal microbatches,
    run one after the other: the mean of their mean-loss gradients makes one
    update, and the BatchNorm statistics move once per microbatch, each
    from the last. A batch that does not split evenly is refused. The
    model is left in ``eval()`` mode."""
    loss_fn = loss_fn or _cross_entropy
    use_bn = _has_batch_norm(model) if has_batch_stats is None else has_batch_stats

    def micro_step(images, labels):
        logits, _ = model(images)
        loss = loss_fn(logits, labels)
        loss.backward()
        return loss.detach(), (logits.detach().argmax(-1) == labels).float().mean()

    def train_step(state: TrainState, images, labels):
        optimizer = tx or state.optimizer
        device = next(model.parameters()).device
        images = as_tensor(images, device, torch.float32)
        labels = as_tensor(labels, device).long()
        b = images.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps={accum_steps}")
        optimizer.zero_grad(set_to_none=True)
        model.train(use_bn)
        try:
            if accum_steps == 1:
                loss, accuracy = micro_step(images, labels)
            else:
                mb = b // accum_steps
                loss = accuracy = 0.0
                for i in range(accum_steps):
                    loss_i, acc_i = micro_step(images[i * mb:(i + 1) * mb], labels[i * mb:(i + 1) * mb])
                    loss, accuracy = loss + loss_i, accuracy + acc_i
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
                loss, accuracy = loss / accum_steps, accuracy / accum_steps
        finally:
            model.eval()
        optimizer.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": accuracy}

    return train_step


def fit_classifier(
    model: nn.Module,
    data_iter: Iterable,
    generator: Optional[torch.Generator] = None,
    epochs: int = 1,
    learning_rate: float = 1e-3,
    tx=None,
    log_every: int = 0,
) -> Tuple[nn.Module, Dict[str, float]]:
    """Train a tapped classifier on ``(images, labels)`` batches (arrays go
    to the model's device); returns the trained model (in ``eval()`` mode)
    and the last step's metrics. ``data_iter`` is iterated once an epoch."""
    state, optimizer = create_train_state(model, generator, tx, learning_rate)
    step_fn = make_train_step(model, optimizer)
    metrics: Dict[str, Any] = {}
    for _ in range(epochs):
        for images, labels in data_iter:
            state, metrics = step_fn(state, images, labels)
            if log_every and state.step % log_every == 0:
                print(f"step {state.step}: loss={float(metrics['loss']):.4f} acc={float(metrics['accuracy']):.3f}")
    return model, {k: float(v) for k, v in metrics.items()}
