"""Faults of the ``larex`` program's timed path, for the CPU tests: each
function breaks it underneath with ``monkeypatch`` and the run that follows
must come out not correct. A cell lists the faults it can have, by name, in
``tiny/faults/<cell>.json``.

Every batch's or request's answer altered where it is produced, and a wrong
draw in the tail batch or in one batch in flight of each call only. A
wrong draw moves a ResNet-50 score far less than a ResNet-18 one (its
7 x 7 tap averages the mask out), so there a wrong draw shows in one batch
of five and in every second request, not in the tail batch alone (in the
full-size cell, 16 of 10,000 images). The batches are those of the CPU
sizes (``tiny/traffic``): 72 images make four batches of 16 and a tail of 8.
"""

import numpy as np
import torch

BATCHES = 5


class Counter:
    """Counts the scorer's calls: warm-up and window alike, each a batch."""

    def __init__(self):
        self.calls = 0

    def __call__(self):
        index = self.calls
        self.calls += 1
        return index


def redrawn(monkeypatch, which):
    """The scorer's DropBlock draw taken from another generator in the
    batches that ``which(call index, batch size)`` picks."""
    from runia_core_tpu_torch.inference import image_level

    draw, count = image_level.mc_dropblock_weights, Counter()

    def weights(batch, height, width, samples, size, prob, generator, device):
        if which(count(), batch):
            generator = torch.Generator(device=device).manual_seed(123_457)
        return draw(batch, height, width, samples, size, prob, generator, device)

    monkeypatch.setattr(image_level, "mc_dropblock_weights", weights)


def tail_batch_redrawn(monkeypatch):
    """The tail batch of each ``score_dataset`` call (8 images, padded to
    16 on the host) drawn wrong."""
    redrawn(monkeypatch, lambda index, batch: index % BATCHES == BATCHES - 1)


def one_batch_redrawn(monkeypatch):
    """One batch in flight of each call (the third of five) drawn wrong."""
    redrawn(monkeypatch, lambda index, batch: index % BATCHES == 2)


def half_the_requests_redrawn(monkeypatch):
    """Every second request drawn wrong."""
    redrawn(monkeypatch, lambda index, batch: index % 2 == 1)


def altered_logit(monkeypatch):
    """The forward's first logit of every batch moved by one."""
    from portbench.families import resnet

    build = resnet.build_forward

    def build_forward(*args):
        forward = build(*args)

        def altered(images):
            logits, taps = forward(images)
            logits = logits.clone()
            logits[0, 0] += 1.0
            return logits, taps

        return altered

    monkeypatch.setattr(resnet, "build_forward", build_forward)


def keep_weights_ignored(monkeypatch):
    """The scorer's DropBlock draw replaced by all-ones keep-weights."""
    from runia_core_tpu_torch.inference import image_level

    def ones(batch, height, width, samples, *args, **kwargs):
        return torch.ones((batch, samples, height * width))

    monkeypatch.setattr(image_level, "mc_dropblock_weights", ones)


def whitening_dropped(monkeypatch):
    """The scorer's PCA projection without its whitening."""
    from runia_core_tpu_torch.inference import image_level

    def unwhitened(state, samples):
        return (samples - state.mean) @ state.components.T

    monkeypatch.setattr(image_level, "pca_transform", unwhitened)


def altered_score(monkeypatch):
    """The detector's answer for the first image of every batch moved by
    100 (LaREM: its quadratic form; LaRED: its log density)."""
    from runia_core_tpu_torch.inference import image_level

    quadform, density = image_level.mahalanobis_quadform, image_level.kde_log_density

    def moved(fn):
        def altered(*args):
            out = fn(*args).clone()
            out[0] += 100.0
            return out

        return altered

    monkeypatch.setattr(image_level, "mahalanobis_quadform", moved(quadform))
    monkeypatch.setattr(image_level, "kde_log_density", moved(density))


def resize_nearest(monkeypatch):
    """The loader's resize taking the nearest source pixel where it should
    interpolate between four."""
    from runia_core_tpu_torch import data

    def nearest(images_u8, indices, size, scale=1.0 / 255.0, offset=0.0, num_threads=4, native=True, out=None):
        _, h_in, w_in, _ = images_u8.shape
        rows = np.minimum(((np.arange(size[0]) + 0.5) * h_in / size[0]).astype(np.int64), h_in - 1)
        cols = np.minimum(((np.arange(size[1]) + 0.5) * w_in / size[1]).astype(np.int64), w_in - 1)
        batch = images_u8[np.asarray(indices)][:, rows][:, :, cols].astype(np.float32) * scale + offset
        if out is None:
            return batch
        out[...] = batch
        return out

    monkeypatch.setattr(data, "gather_resize_normalize", nearest)
