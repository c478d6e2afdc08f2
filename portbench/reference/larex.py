"""Plain LaREx scoring, the benchmark's reference after the forward.

The stages, each written out in plain ``torch`` and computed in float64:

* DropBlock keep-weights from the uniform draws: seed = u < p / b^2, a
  b x b max-pool (stride 1, padding b // 2, the last row and column
  trimmed for an even b), keep = 1 - pooled, scaled per image by
  H*W / max(sum(keep), 1);
* the S Monte-Carlo samples of an image, the keep-weighted channel means
  of the tap: (S, HW) @ (HW, C) / HW;
* the Kozachenko-Leonenko entropy of each channel's S samples under the
  max norm: -psi(k) + psi(S) + mean_i log(2 max(eps_i, 1e-5)), eps_i the
  distance from sample i to its k-th nearest neighbour;
* PCA fitted on the training entropies (eigenvectors of the covariance),
  whitened by the explained variance S^2 / (n - 1);
* LaREM: minus the Mahalanobis distance to the training embeddings' mean
  under the inverse of their (1/n) covariance; LaRED: a Gaussian KDE's log
  density, log mean_i exp(-|x - t_i|^2 / (2 h^2)) - (d / 2) log(2 pi h^2).

The pipeline fits its own PCA and detector from its own entropies.

The module imports nothing of the program and takes nothing that it made.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

F64 = torch.float64
MIN_DIST = 1e-5


def keep_weights(uniforms: torch.Tensor, drop_prob: float, block_size: int) -> torch.Tensor:
    """(B, S, H, W) uniforms -> (B, S, H*W) keep-weights, float64."""
    b, s, h, w = uniforms.shape
    seed = (uniforms < drop_prob / block_size**2).to(F64).reshape(b * s, 1, h, w)
    pooled = F.max_pool2d(seed, block_size, 1, block_size // 2)
    if block_size % 2 == 0:
        pooled = pooled[:, :, :-1, :-1]
    keep = 1.0 - pooled.reshape(b, s, h * w)
    return keep * (h * w) / keep.sum(dim=2, keepdim=True).clamp_min(1.0)


def mc_samples(tap: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) tap and (B, S, HW) keep-weights -> (B, S, C) samples."""
    b, h, w, c = tap.shape
    return torch.bmm(weights.to(F64), tap.to(F64).reshape(b, h * w, c)) / (h * w)


def digamma_int(n: int) -> float:
    """psi(n) for a positive integer: -gamma + sum_{m < n} 1 / m."""
    return -0.5772156649015329 + sum(1.0 / m for m in range(1, n))


def kl_entropy(samples: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S, C) -> (B, C): each channel's entropy over its S samples."""
    n = samples.shape[1]
    x = samples.to(F64)
    dist = (x[:, :, None, :] - x[:, None, :, :]).abs()  # (B, S, S, C)
    kth = torch.kthvalue(dist, k + 1, dim=2).values  # the 0 to itself is the first
    return -digamma_int(k) + digamma_int(n) + torch.log(2.0 * kth.clamp_min(MIN_DIST)).mean(dim=1)


def covariance(h: torch.Tensor) -> torch.Tensor:
    centred = h.to(F64) - h.to(F64).mean(dim=0)
    return centred.T @ centred / (h.shape[0] - 1)


def spectrum(h: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The mean (d,) of the rows of ``h`` and every eigenvalue (d,) and
    eigenvector (d, d, as columns) of their (1/(n-1)) covariance, the
    largest first."""
    values, vectors = torch.linalg.eigh(covariance(h))
    return {"mean": h.to(F64).mean(dim=0), "values": values.flip(0), "vectors": vectors.flip(1)}


def pca_state(whole: Dict[str, torch.Tensor], components: int) -> Dict[str, torch.Tensor]:
    """The PCA of ``components`` leading components: the mean (d,), the
    components as rows (k, d) and their variances (k,)."""
    return {"mean": whole["mean"], "components": whole["vectors"][:, :components].T.contiguous(),
            "variance": whole["values"][:components]}


def project(state: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Whitened PCA embeddings of the rows of ``h`` under ``state``."""
    dev = h.device
    return ((h.to(F64) - state["mean"].to(dev, F64)) @ state["components"].to(dev, F64).T
            / torch.sqrt(state["variance"].to(dev, F64)))


def pca_gap(state: Dict[str, torch.Tensor], h: torch.Tensor) -> float:
    """How far a fitted PCA ``state`` lies from the PCA of the rows of ``h``,
    in measures that stay well conditioned where eigenvalues lie close
    together (there an eigenvector may turn freely): the largest of

    * each component's variance against the variance of ``h`` along it,
    * each component's mean offset, in standard deviations along it,
    * the share of the leading k eigenvalues' variance that the k
      components miss.
    """
    dev = h.device
    cov = covariance(h)
    v = state["components"].to(dev, F64)
    along = ((v @ cov) * v).sum(dim=1)
    variance = (state["variance"].to(dev, F64) / along - 1.0).abs().max()
    offset = ((v @ (state["mean"].to(dev, F64) - h.to(F64).mean(dim=0))).abs() / along.sqrt()).max()
    best = torch.linalg.eigvalsh(cov).flip(0)[: v.shape[0]].sum()
    missed = 1.0 - along.sum() / best
    return float(torch.stack([variance, offset, missed.abs()]).max())


class Mahalanobis:
    """LaREM: -(x - mean) inv(cov) (x - mean)^T, cov the (1/n) covariance."""

    def __init__(self, train: torch.Tensor):
        train = train.to(F64)
        self.mean = train.mean(dim=0)
        centred = train - self.mean
        self.precision = torch.linalg.inv(centred.T @ centred / train.shape[0])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        diff = x.to(F64) - self.mean
        return -((diff @ self.precision) * diff).sum(dim=1)


def log_mean_exp_kernel(x: torch.Tensor, train: torch.Tensor, bandwidth: float, rows: int = 256) -> torch.Tensor:
    """log mean_i exp(-|x - t_i|^2 / (2 h^2)) of each row of ``x``."""
    out = []
    for chunk in torch.split(x.to(F64), rows):
        sq = torch.cdist(chunk, train.to(F64)).square()
        out.append(torch.logsumexp(-sq / (2.0 * bandwidth**2), dim=1))
    return torch.cat(out) - math.log(train.shape[0])


class GaussianKDE:
    """LaRED: the log density of a Gaussian KDE with bandwidth ``h``."""

    def __init__(self, train: torch.Tensor, bandwidth: float):
        self.train = train.to(F64)
        self.bandwidth = bandwidth

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        d = self.train.shape[1]
        return (log_mean_exp_kernel(x, self.train, self.bandwidth)
                - 0.5 * d * math.log(2.0 * math.pi * self.bandwidth**2))


def entropies(
    forward: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    images: torch.Tensor,
    uniforms: torch.Tensor,
    larex: dict,
    rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, entropies) of ``images`` with the keep-weights of
    ``uniforms`` (both with the same rows), ``rows`` images at a time."""
    logits, out = [], []
    for start in range(0, images.shape[0], rows):
        part_logits, tap = forward(images[start:start + rows])
        weights = keep_weights(uniforms[start:start + rows], larex["drop_prob"], larex["block_size"])
        out.append(kl_entropy(mc_samples(tap, weights), larex["k"]))
        logits.append(part_logits)
    return torch.cat(logits), torch.cat(out)


class Pipeline:
    """The LaREx computation from its own forward: the entropies of the fit
    set (and of a KDE's support set, ``support``: (images, uniforms) or
    None), its own PCA of them (``state``), its own detector fitted on the
    fit set's (LaREM) or support set's (LaRED) embeddings, and the logits,
    entropies and scores of new images under their draws."""

    def __init__(self, forward, larex: dict, detector: dict, fit: Tuple[torch.Tensor, torch.Tensor],
                 support: Optional[Tuple[torch.Tensor, torch.Tensor]], rows: int):
        self.forward, self.larex, self.detector, self.rows = forward, larex, detector, rows
        _, self.h_fit = entropies(forward, *fit, larex, rows)
        self.h_support = entropies(forward, *support, larex, rows)[1] if support is not None else None
        self.whole = spectrum(self.h_fit)
        self.state = pca_state(self.whole, larex["pca_components"])
        if detector["name"] == "MD":
            self.score = Mahalanobis(project(self.state, self.h_fit))
        elif detector["name"] == "KDE":
            self.score = GaussianKDE(project(self.state, self.h_support), detector["bandwidth"])
        else:
            raise ValueError(f"unknown detector {detector['name']!r}")

    def __call__(self, images: torch.Tensor, uniforms: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(logits float32, entropies float64, scores float64) of images
        under their draws."""
        logits, h = entropies(self.forward, images, uniforms, self.larex, self.rows)
        return logits, h, self.score(project(self.state, h))

    def pca_gap(self, state: Dict[str, torch.Tensor]) -> float:
        """:func:`pca_gap` of a PCA ``state`` against this fit's entropies."""
        return pca_gap(state, self.h_fit)
