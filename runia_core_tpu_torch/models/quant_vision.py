"""Post-training int8 quantization (PTQ) of the port's ResNet family.

Counterpart of ``runia_core_tpu/models/quant_vision.py``. It turns a
:class:`runia_core_tpu_torch.models.ResNet` into an int8 program with the
``build_tapped_forward`` contract, so the LaREx scorer, the extractors and
``LaRExInference`` take it unchanged:

    qforward = quantize_resnet(model, calib_images)
    # images -> (logits, {tap: f32 tensor})

Scheme (the JAX package's, code for code):

- **BN folding**: inference-mode BatchNorm is a per-channel affine, so
  ``BN(conv(x, w))`` folds to ``conv(x, w * g) + (beta - mean * g)`` with
  ``g = gamma / sqrt(var + eps)``, on the host in numpy f32, as the JAX
  package folds.
- **Weights**: symmetric per-output-channel int8 on the folded kernel,
  ``w_scale = max(max|w_c|, 1e-12) / 127``, ``w_q = clip(round(w / w_scale))``
  in numpy f32 on the host (round half to even): the JAX package's codes
  bit for bit.
- **Activations**: symmetric per-tensor int8; each conv input's scale is the
  ``act_quantile`` percentile of |x| over a calibration batch, computed with
  the JAX calibration's f32 arithmetic (:func:`jax_percentile`), not numpy's.
- **Compute**: the int8 codes of the input are gathered into patches (a
  strided view of the padded NHWC codes and one copy) and multiplied by the
  int8 kernel with ``torch._int_mm``: exact int32 sums (cuBLASLt's integer
  tensor-core GEMM on the card). Then one f32 rescale, the bias and the
  ReLU; residual adds in f32; taps and logits in f32, so the LaREx stack
  downstream is unchanged. The integer GEMM wants more than 16 rows and
  depths and widths that are multiples of 8: the patches and the kernel are
  padded with zero codes to those sizes, which adds nothing to a sum.

Calibration runs where the model's weights are (the card) unless the caller
passes ``calib_device="cpu"``; the JAX package calibrates on the host CPU by
default to spare a remote compile. The placement differs; the result does
not (the card's codes equal the CPU's, and the scales agree to the order of
the reductions' rounding).

One structural walk, :func:`_conv_sites` -> :func:`_forward`, drives
calibration, quantization and the int8 forward, so the three cannot drift
apart.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from runia_core_tpu_torch.models.resnet import ResNet, ResNetBlock, same_padding
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = ["int8_conv", "jax_percentile", "quantize_resnet", "quantize_resnet_params"]

_BN_EPS = 1e-5  # models/resnet.py BatchNorm
_ALIGN = 8  # the integer GEMM's depth and width multiple
_MIN_ROWS = 17  # the integer GEMM's least row count on the card


# ---------------------------------------------------------------------------
# Structural walk
# ---------------------------------------------------------------------------


def _is_basic(model: ResNet) -> bool:
    return model.block_cls is ResNetBlock


def _conv_sites(model: ResNet) -> List[Dict]:
    """Every conv+BN site in call order: {parent, conv, bn, stride, kind};
    ``parent`` is the block's module name ("" at the top level). A block's
    ``conv_proj`` site is listed whether or not the block has one."""
    sites = [{"parent": "", "conv": "conv_init", "bn": "bn_init", "stride": 1 if model.cifar_stem else 2,
              "kind": "stem"}]
    basic = _is_basic(model)
    for i, block_size in enumerate(model.stage_sizes):
        for j in range(block_size):
            parent = f"stage{i + 1}_block{j}"
            stride = 2 if i > 0 and j == 0 else 1
            if basic:
                convs = [("Conv_0", "BatchNorm_0", stride), ("Conv_1", "BatchNorm_1", 1)]
            else:
                convs = [("Conv_0", "BatchNorm_0", 1), ("Conv_1", "BatchNorm_1", stride),
                         ("Conv_2", "BatchNorm_2", 1)]
            for conv, bn, s in convs:
                sites.append({"parent": parent, "conv": conv, "bn": bn, "stride": s, "kind": "block"})
            sites.append({"parent": parent, "conv": "conv_proj", "bn": "norm_proj", "stride": stride,
                          "kind": "proj"})
    return sites


def _scope(model: ResNet, site: Dict):
    return model.get_submodule(site["parent"]) if site["parent"] else model


def _site_exists(model: ResNet, site: Dict) -> bool:
    return hasattr(_scope(model, site), site["conv"])


def _site_key(site: Dict) -> str:
    return f"{site['parent']}/{site['conv']}" if site["parent"] else site["conv"]


def _fold_bn(model: ResNet, site: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """The BN-folded f32 kernel (kh, kw, I, O) and bias (O,) of one site, on
    the host in numpy f32: the JAX package's operations in its order,
    wherever the calibration runs (a fold on the card parts from numpy's in
    the last bit of some channels' scale)."""
    scope = _scope(model, site)
    conv, bn = getattr(scope, site["conv"]), getattr(scope, site["bn"])

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy()

    w = host(conv.weight).transpose(2, 3, 1, 0)
    g = host(bn.weight) / np.sqrt(host(bn.running_var) + np.float32(_BN_EPS))
    bias = host(bn.bias) - host(bn.running_mean) * g
    return np.ascontiguousarray(w * g[None, None, None, :]), bias


def _host_folds(model: ResNet) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """site key -> the folded (kernel, bias) of every conv the model has."""
    return {_site_key(s): _fold_bn(model, s) for s in _conv_sites(model) if _site_exists(model, s)}


def _on(folds: Dict[str, Tuple[np.ndarray, np.ndarray]], device: torch.device) -> Dict[str, Tuple[torch.Tensor, ...]]:
    return {key: tuple(torch.from_numpy(a).to(device) for a in pair) for key, pair in folds.items()}


def _conv_padding(model: ResNet, site: Dict, kernel_hw: Tuple[int, int], in_hw: Tuple[int, int]):
    """((top, bottom), (left, right)) of one site's conv."""
    if site["kind"] == "stem" and not model.cifar_stem:
        return (3, 3), (3, 3)
    if model.torch_padding:
        return tuple((k // 2, k // 2) for k in kernel_hw)
    return tuple(same_padding(n, k, site["stride"]) for n, k in zip(in_hw, kernel_hw))


def _max_pool(model: ResNet, x: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3/2 max-pool on an NHWC tensor."""
    if model.torch_padding:
        pads = ((1, 1), (1, 1))
    else:
        pads = tuple(same_padding(n, 3, 2) for n in x.shape[1:3])
    (h_lo, h_hi), (w_lo, w_hi) = pads
    y = F.pad(x.permute(0, 3, 1, 2), (w_lo, w_hi, h_lo, h_hi), value=-float("inf"))
    return F.max_pool2d(y, 3, 2).permute(0, 2, 3, 1)


def _forward(model: ResNet, x: torch.Tensor, conv_bn: Callable[[torch.Tensor, Dict], torch.Tensor],
             head: Tuple[torch.Tensor, torch.Tensor]):
    """``ResNet.forward``'s control flow on NHWC f32 tensors, with conv+BN
    delegated to ``conv_bn(x, site)`` (the f32 post-BN, pre-ReLU output)."""
    sites = iter(_conv_sites(model))
    taps: Dict[str, torch.Tensor] = {}
    x = torch.relu(conv_bn(x, next(sites)))
    if not model.cifar_stem:
        x = _max_pool(model, x)
    taps["stem"] = x
    n_convs = 2 if _is_basic(model) else 3
    for i, block_size in enumerate(model.stage_sizes):
        for j in range(block_size):
            residual = y = x
            for c in range(n_convs):
                y = conv_bn(y, next(sites))
                if c < n_convs - 1:
                    y = torch.relu(y)
            proj_site = next(sites)
            if residual.shape != y.shape:
                residual = conv_bn(residual, proj_site)
            x = torch.relu(residual + y)
        taps[f"block{i + 1}"] = x
    taps["pre_pool"] = x
    x = x.mean(dim=(1, 2))
    taps["penultimate"] = x
    kernel, bias = head
    return x @ kernel + bias, taps


def _head(model: ResNet, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense head as (kernel (in, out), bias), f32 on ``device``."""
    return (model.head.weight.detach().to(device, torch.float32).T.contiguous(),
            model.head.bias.detach().to(device, torch.float32))


def _float_conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding) -> torch.Tensor:
    """f32 convolution of an NHWC input with an HWIO kernel, explicit padding."""
    (h_lo, h_hi), (w_lo, w_hi) = padding
    y = F.pad(x.permute(0, 3, 1, 2), (w_lo, w_hi, h_lo, h_hi))
    return F.conv2d(y, w.permute(3, 2, 0, 1), None, stride).permute(0, 2, 3, 1)


def _model_device(model: ResNet) -> torch.device:
    return model.conv_init.weight.device


def _float_forward(model: ResNet) -> Callable:
    """The f32 BN-folded mirror of the model's forward (the calibration
    path), exposed for tests that hold it against the model itself."""
    device = _model_device(model)
    folded = _on(_host_folds(model), device)
    head = _head(model, device)

    def conv_bn(x, site):
        w, bias = folded[_site_key(site)]
        return _float_conv(x, w, site["stride"], _conv_padding(model, site, w.shape[:2], x.shape[1:3])) + bias

    @torch.inference_mode()
    def forward(images):
        return _forward(model, as_tensor(images, device, torch.float32), conv_bn, head)

    return forward


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _fma_f32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """``a * b + c`` rounded once to f32 (to nearest, ties to even), as a
    fused multiply-add does: the exact value from fractions, then the
    nearest of the three f32 values around its f64 rounding."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    guess = np.float32(float(exact))
    candidates = (np.nextafter(guess, np.float32(-np.inf)), guess, np.nextafter(guess, np.float32(np.inf)))
    return min(candidates, key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.uint32)) & 1))


def jax_percentile(x: torch.Tensor, q: float) -> float:
    """The ``q`` percentile of every element of ``x`` as the JAX package's
    calibration computes it (``jnp.percentile`` inside its jitted pass on
    the CPU, ``q`` a constant), as the Python float of an f32:

    - ``q`` becomes ``f32(q) / f32(100)`` (99.9 -> 0.999f, folded exactly);
    - the index is ``q * (f32(n) - 1)`` in f32, its floor and ceiling the
      two order statistics (``torch.kthvalue`` on x's device, since
      ``torch.quantile`` refuses inputs above 2^24 values);
    - the result is ``low * (1 - w) + round(high * w)`` with one rounding
      for the first product and the sum: XLA's CPU backend contracts the
      interpolation into a fused multiply-add.

    ``np.percentile``, which forms the index in f64 and rounds each product,
    can differ in the last bits or pick other order statistics below about
    2.6e5 values. (A ``jnp.percentile`` called outside ``jit`` differs again:
    there XLA divides ``q`` by 100 as ``q * 0.01``, 0.99899995.)"""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    quantile = np.float32(q) / np.float32(100)
    index = quantile * (np.float32(n) - np.float32(1))
    low, high = np.floor(index), np.ceil(index)
    high_weight = index - low
    low_weight = np.float32(1) - high_weight
    lo = int(np.clip(low, 0, n - 1))
    hi = int(np.clip(high, 0, n - 1))
    low_value = np.float32(torch.kthvalue(flat, lo + 1).values.item())
    high_value = low_value if hi == lo else np.float32(torch.kthvalue(flat, hi + 1).values.item())
    return float(_fma_f32(low_value, low_weight, high_value * high_weight))


def quantize_resnet_params(
    model: ResNet,
    calib_images,
    act_quantile: float = 99.9,
    calib_device=None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Calibrate and quantize: ``{site_key: {w_q, w_scale, bias, x_scale}}``
    as numpy arrays, the JAX package's layout (``w_q`` (kh, kw, I, O) int8,
    ``w_scale`` and ``bias`` (O,) f32, ``x_scale`` an f32 scalar).

    ``calib_images`` is a representative in-distribution batch (a few
    hundred NHWC images); the scale of each conv input is the
    ``act_quantile`` percentile of its |x|. The pass runs on
    ``calib_device``: None is where the model's weights are (the card);
    ``"cpu"`` calibrates on the host (the JAX package's default). Two order
    statistics per site leave the device; the BN fold and the weight codes
    are made on the host in numpy f32, as the JAX package makes them.
    """
    if model.s2d_stem:
        raise NotImplementedError(
            "quantize_resnet does not model the space-to-depth stem: the "
            "structural mirror would skip the input rearrange and run the "
            "4x4 kernel at stride 2, silently diverging. Quantize the plain "
            "7x7-stem model (int8 only wins on small-image compute-bound "
            "configs, where s2d_stem is moot — see docs/PERFORMANCE.md)."
        )
    if model.output_stride is not None or not model.include_head:
        raise NotImplementedError(
            "quantize_resnet supports plain classification ResNets only "
            "(output_stride=None, include_head=True): the structural mirror "
            "does not model atrous stages, and dilated backbones run at "
            "large HBM-bound resolutions where int8 loses anyway — see "
            "docs/PERFORMANCE.md 'Where int8 does NOT win'."
        )
    device = _model_device(model) if calib_device is None else torch.device(calib_device)
    host_folds = _host_folds(model)
    folded = _on(host_folds, device)
    records: Dict[str, float] = {}

    def calib_conv_bn(x, site):
        key = _site_key(site)
        w, bias = folded[key]
        records[key] = jax_percentile(x.abs(), act_quantile)
        return _float_conv(x, w, site["stride"], _conv_padding(model, site, w.shape[:2], x.shape[1:3])) + bias

    with torch.inference_mode():
        images = torch.as_tensor(calib_images, dtype=torch.float32, device=device)
        _forward(model, images, calib_conv_bn, _head(model, device))

    qparams: Dict[str, Dict[str, np.ndarray]] = {}
    for key, (w, bias) in host_folds.items():
        w_scale = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(axis=0), np.float32(1e-12)) / np.float32(127.0)
        qparams[key] = {
            "w_q": np.clip(np.round(w / w_scale), -127, 127).astype(np.int8),
            "w_scale": w_scale.astype(np.float32),
            "bias": bias.astype(np.float32),
            "x_scale": np.float32(max(records[key], 1e-12) / 127.0),
        }
    return qparams


# ---------------------------------------------------------------------------
# The int8 forward
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _weight_matrix(w_q: torch.Tensor) -> torch.Tensor:
    """An HWIO int8 kernel as the (O', K') operand of :func:`int8_conv`: rows
    are output channels, columns the (kh, kw, I) patch order, both padded
    with zero codes to multiples of 8."""
    kh, kw, cin, cout = w_q.shape
    k = kh * kw * cin
    mat = torch.zeros((_round_up(cout, _ALIGN), _round_up(k, _ALIGN)), dtype=torch.int8, device=w_q.device)
    mat[:cout, :k] = w_q.reshape(k, cout).T
    return mat


def int8_conv(xq: torch.Tensor, w_mat: torch.Tensor, kernel_hw: Tuple[int, int], out_channels: int,
              stride: int, padding) -> torch.Tensor:
    """The exact int32 convolution of NHWC int8 codes ``xq`` (B, H, W, C)
    with the kernel matrix ``w_mat`` (O', K') of :func:`_weight_matrix`:
    (B, Ho, Wo, out_channels) int32.

    The padded codes are read through a strided (B, Ho, Wo, kh, kw, C) view
    and copied once into the (M', K') patch matrix (zero codes pad the depth
    to K' and the rows to at least 17), then ``torch._int_mm(patches,
    w_mat.T)`` sums in int32."""
    (h_lo, h_hi), (w_lo, w_hi) = padding
    kh, kw = kernel_hw
    x = F.pad(xq, (0, 0, w_lo, w_hi, h_lo, h_hi)) if (h_lo or h_hi or w_lo or w_hi) else xq
    b, hp, wp, c = x.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    sb, sh, sw, sc = x.stride()
    view = x.as_strided((b, ho, wo, kh, kw, c), (sb, stride * sh, stride * sw, sh, sw, sc))
    m, k = b * ho * wo, kh * kw * c
    k_pad = w_mat.shape[1]
    rows = max(m, _MIN_ROWS)
    if k_pad == k and rows == m:
        patches = view.reshape(m, k)
    else:
        patches = torch.zeros((rows, k_pad), dtype=torch.int8, device=x.device)
        patches[:m, :k].view(b, ho, wo, kh, kw, c).copy_(view)
    acc = torch._int_mm(patches, w_mat.T)
    return acc[:m, :out_channels].reshape(b, ho, wo, out_channels)


def quantize_resnet(
    model: ResNet,
    calib_images,
    taps: Sequence[str] = ("pre_pool",),
    act_quantile: float = 99.9,
    qparams: Optional[Dict] = None,
    calib_device=None,
) -> Callable:
    """The int8 forward with the ``build_tapped_forward`` contract:
    ``forward(images) -> (logits, {tap: f32 tensor})``, on the model's
    device. ``qparams`` (from :func:`quantize_resnet_params`, reloaded from
    a checkpoint or made by the JAX package) skips calibration. The forward
    makes no host sync, so a CUDA graph captures it."""
    if qparams is None:
        qparams = quantize_resnet_params(model, calib_images, act_quantile=act_quantile,
                                         calib_device=calib_device)
    device = _model_device(model)
    head = _head(model, device)
    dev_q = {}
    for key, p in qparams.items():
        w_q = as_tensor(np.asarray(p["w_q"], np.int8), device)
        x_scale = as_tensor(np.asarray(p["x_scale"], np.float32), device)
        dev_q[key] = {
            "w_mat": _weight_matrix(w_q), "kernel_hw": tuple(w_q.shape[:2]), "out": int(w_q.shape[-1]),
            "x_scale": x_scale,
            "rescale": x_scale * as_tensor(np.asarray(p["w_scale"], np.float32), device),
            "bias": as_tensor(np.asarray(p["bias"], np.float32), device),
        }
    wanted = tuple(taps)

    def qconv_bn(x, site):
        p = dev_q[_site_key(site)]
        xq = torch.clamp(torch.round(x / p["x_scale"]), -127, 127).to(torch.int8)
        pad = _conv_padding(model, site, p["kernel_hw"], x.shape[1:3])
        acc = int8_conv(xq, p["w_mat"], p["kernel_hw"], p["out"], site["stride"], pad)
        return acc.to(torch.float32) * p["rescale"] + p["bias"]

    @torch.inference_mode()
    def forward(images):
        logits, all_taps = _forward(model, as_tensor(images, device, torch.float32), qconv_bn, head)
        return logits, {name: all_taps[name] for name in wanted}

    return forward
