"""YOLOv8 detection in PyTorch, with an ultralytics converter and adapter.

Counterpart of ``runia_core_tpu/models/yolov8.py``. The anchor-free v8
detector: CSP backbone (Conv / C2f / SPPF) -> PAN-FPN neck (nearest 2x
upsampling and concat top-down, strided Conv and concat bottom-up) -> per
scale decoupled heads (4 * reg_max DFL logits, nc class logits) -> the DFL
expectation -> dist2bbox against cell-centre anchors -> the ultralytics
eval tensor (B, 4 + nc, sum HW), xywh in pixels then sigmoid class scores.
ultralytics' conventions are kept: BatchNorm eps 1e-3, SiLU, symmetric
k // 2 padding, anchors at cell centres (+0.5), strides 8 / 16 / 32.

Images are NHWC, as in the JAX package; inside, tensors are NCHW views, so
an NHWC input runs the convolutions channels-last on the card and the NHWC
taps (``p3``, ``p4``, ``p5``, ``backbone_p5``) are contiguous. Module names
follow the flax tree (``layer{i}``, ``cv1``, ``m{j}``, ``head_box{l}_{j}``),
so ``models/convert.py::yolov8_from_flax`` carries a JAX model across;
:func:`convert_ultralytics_yolov8` maps an ultralytics ``state_dict``
(``model.{i}.*``) straight onto the module. :class:`YoloV8JaxAdapter` (the
JAX package's name) runs the detection protocol with the NMS kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.extraction.adapters import DetectionResult
from runia_core_tpu_torch.models.resnet import BatchNorm
from runia_core_tpu_torch.ops.nms import nms_keep
from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, copy_to_host
from runia_core_tpu_torch.utils.placement import as_tensor

__all__ = [
    "Bottleneck", "C2f", "ConvBNSiLU", "SPPF", "YoloV8", "YoloV8JaxAdapter", "convert_ultralytics_yolov8",
    "yolov8_widths",
]

_BN_EPS = 1e-3  # ultralytics BatchNorm2d(eps=0.001)


class ConvBNSiLU(nn.Module):
    """ultralytics ``Conv``: a bias-free conv with symmetric k // 2 padding,
    BatchNorm (running statistics), SiLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, stride, kernel // 2, bias=False)
        self.bn = BatchNorm(features, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Two 3x3 Convs with an optional residual."""

    def __init__(self, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBNSiLU(features, features, 3)
        self.cv2 = ConvBNSiLU(features, features, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial block: cv1's output split in two, n bottlenecks
    chained on the second half, every part concatenated into cv2."""

    def __init__(self, in_features: int, features: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.c = features // 2
        self.n = n
        self.cv1 = ConvBNSiLU(in_features, 2 * self.c, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(self.c, shortcut))
        self.cv2 = ConvBNSiLU((2 + n) * self.c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c :]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained stride-1 5x5 max-pools."""

    def __init__(self, in_features: int, features: int, pool: int = 5):
        super().__init__()
        c = in_features // 2
        self.pool = pool
        self.cv1 = ConvBNSiLU(in_features, c, 1)
        self.cv2 = ConvBNSiLU(4 * c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.pool, 1, self.pool // 2))
        return self.cv2(torch.cat(pools, dim=1))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def yolov8_widths(scale: str = "n") -> Dict[str, Any]:
    """The (depth, width, ratio)-resolved channel plan of a v8 scale."""
    d, w, r = {
        "n": (1 / 3, 0.25, 2.0),
        "s": (1 / 3, 0.50, 2.0),
        "m": (2 / 3, 0.75, 1.5),
        "l": (1.0, 1.00, 1.0),
        "x": (1.0, 1.25, 1.0),
    }[scale]

    def ch(c):
        return int(round(c * w))

    def rep(n):
        return max(1, round(n * d))

    return {
        "c1": ch(64), "c2": ch(128), "c3": ch(256), "c4": ch(512),
        "c5": int(round(512 * w * r)),
        "n_small": rep(3), "n_big": rep(6),
    }


class YoloV8(nn.Module):
    """Anchor-free YOLOv8. ``forward(images)`` -> (predictions, taps):
    ``predictions`` is the ultralytics eval tensor (B, 4 + nc, sum HW), f32.
    Made on ``device`` (None: the GPU), in eval mode."""

    def __init__(self, num_classes: int, scale: str = "n", reg_max: int = 16, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.scale = scale
        self.reg_max = reg_max
        cfg = yolov8_widths(scale)
        c1, c2, c3, c4, c5 = (cfg[k] for k in ("c1", "c2", "c3", "c4", "c5"))
        ns, nb = cfg["n_small"], cfg["n_big"]
        with torch.device(default_device() if device is None else device):
            self.layer0 = ConvBNSiLU(3, c1, 3, 2)
            self.layer1 = ConvBNSiLU(c1, c2, 3, 2)
            self.layer2 = C2f(c2, c2, ns, True)
            self.layer3 = ConvBNSiLU(c2, c3, 3, 2)
            self.layer4 = C2f(c3, c3, nb, True)
            self.layer5 = ConvBNSiLU(c3, c4, 3, 2)
            self.layer6 = C2f(c4, c4, nb, True)
            self.layer7 = ConvBNSiLU(c4, c5, 3, 2)
            self.layer8 = C2f(c5, c5, ns, True)
            self.layer9 = SPPF(c5, c5)
            self.layer12 = C2f(c5 + c4, c4, ns, False)
            self.layer15 = C2f(c4 + c3, c3, ns, False)
            self.layer16 = ConvBNSiLU(c3, c3, 3, 2)
            self.layer18 = C2f(c3 + c4, c4, ns, False)
            self.layer19 = ConvBNSiLU(c4, c4, 3, 2)
            self.layer21 = C2f(c4 + c5, c5, ns, False)
            cb = max(16, c3 // 4, reg_max * 4)
            cc = max(c3, min(num_classes, 100))
            for li, cin in enumerate((c3, c4, c5)):
                self.add_module(f"head_box{li}_0", ConvBNSiLU(cin, cb, 3))
                self.add_module(f"head_box{li}_1", ConvBNSiLU(cb, cb, 3))
                self.add_module(f"head_box{li}_2", nn.Conv2d(cb, 4 * reg_max, 1))
                self.add_module(f"head_cls{li}_0", ConvBNSiLU(cin, cc, 3))
                self.add_module(f"head_cls{li}_1", ConvBNSiLU(cc, cc, 3))
                self.add_module(f"head_cls{li}_2", nn.Conv2d(cc, num_classes, 1))
        self.eval()

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = images.to(torch.float32).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = self.layer2(self.layer1(self.layer0(x)))
        p3 = self.layer4(self.layer3(x))  # stride 8
        p4 = self.layer6(self.layer5(p3))  # stride 16
        p5 = self.layer9(self.layer8(self.layer7(p4)))  # stride 32
        n4 = self.layer12(torch.cat([_upsample2x(p5), p4], dim=1))  # layers 10, 11
        n3 = self.layer15(torch.cat([_upsample2x(n4), p3], dim=1))  # 13, 14; the P3 output
        h4 = self.layer18(torch.cat([self.layer16(n3), n4], dim=1))  # 17; P4
        h5 = self.layer21(torch.cat([self.layer19(h4), p5], dim=1))  # 20; P5
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        taps = {"backbone_p5": nhwc(p5), "p3": nhwc(n3), "p4": nhwc(h4), "p5": nhwc(h5)}

        flat_box, flat_cls, anchors, strides = [], [], [], []
        for li, (feat, stride) in enumerate(zip((n3, h4, h5), (8, 16, 32))):
            b, _, h, w = feat.shape
            box = getattr(self, f"head_box{li}_2")(getattr(self, f"head_box{li}_1")(getattr(self, f"head_box{li}_0")(feat)))
            cls = getattr(self, f"head_cls{li}_2")(getattr(self, f"head_cls{li}_1")(getattr(self, f"head_cls{li}_0")(feat)))
            flat_box.append(box.reshape(b, 4 * self.reg_max, h * w))
            flat_cls.append(cls.reshape(b, self.num_classes, h * w))
            yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=feat.device) + 0.5,
                                    torch.arange(w, dtype=torch.float32, device=feat.device) + 0.5, indexing="ij")
            anchors.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
            strides.append(torch.full((h * w,), float(stride), device=feat.device))
        box_logits = torch.cat(flat_box, dim=2).permute(0, 2, 1)  # (B, N, 4 * reg_max)
        cls_logits = torch.cat(flat_cls, dim=2)  # (B, nc, N)
        anchor_pts = torch.cat(anchors, dim=0)  # (N, 2), cell units
        stride_all = torch.cat(strides, dim=0)  # (N,)

        b, n, _ = box_logits.shape
        bins = torch.arange(self.reg_max, dtype=torch.float32, device=box_logits.device)
        dist = torch.softmax(box_logits.reshape(b, n, 4, self.reg_max), dim=-1) @ bins  # (B, N, 4) ltrb
        x1y1 = anchor_pts[None] - dist[..., :2]
        x2y2 = anchor_pts[None] + dist[..., 2:]
        boxes = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1) * stride_all[None, :, None]
        preds = torch.cat([boxes.permute(0, 2, 1), torch.sigmoid(cls_logits)], dim=1)  # (B, 4 + nc, N)
        return preds, taps

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "YoloV8":
        """Seeded init after flax's: lecun-normal conv kernels (std
        1/sqrt(fan_in), untruncated), zero head biases, BatchNorm at (scale 1,
        bias 0, mean 0, var 1)."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                noise = torch.randn(module.weight.shape, generator=generator, device=module.weight.device)
                module.weight.copy_(noise / math.sqrt(module.weight[0].numel()))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        return self


def _conv_bn_names(ours: str, theirs: str) -> Dict[str, str]:
    names = {f"{ours}.conv.weight": f"{theirs}.conv.weight"}
    for mine, key in (("weight", "weight"), ("bias", "bias"), ("running_mean", "running_mean"),
                      ("running_var", "running_var")):
        names[f"{ours}.bn.{mine}"] = f"{theirs}.bn.{key}"
    return names


def _ultralytics_names(cfg: Dict[str, Any]) -> Dict[str, str]:
    """The port's state_dict keys -> the ultralytics ``model.{i}.*`` keys."""
    ns, nb = cfg["n_small"], cfg["n_big"]
    names: Dict[str, str] = {}
    for i in (0, 1, 3, 5, 7, 16, 19):
        names.update(_conv_bn_names(f"layer{i}", f"model.{i}"))
    for i, n in {2: ns, 4: nb, 6: nb, 8: ns, 12: ns, 15: ns, 18: ns, 21: ns}.items():
        for cv in ("cv1", "cv2"):
            names.update(_conv_bn_names(f"layer{i}.{cv}", f"model.{i}.{cv}"))
        for j in range(n):
            for cv in ("cv1", "cv2"):
                names.update(_conv_bn_names(f"layer{i}.m{j}.{cv}", f"model.{i}.m.{j}.{cv}"))
    for cv in ("cv1", "cv2"):
        names.update(_conv_bn_names(f"layer9.{cv}", f"model.9.{cv}"))
    for li in range(3):
        for branch, ours in (("cv2", "head_box"), ("cv3", "head_cls")):
            for j in range(2):
                names.update(_conv_bn_names(f"{ours}{li}_{j}", f"model.22.{branch}.{li}.{j}"))
            names[f"{ours}{li}_2.weight"] = f"model.22.{branch}.{li}.2.weight"
            names[f"{ours}{li}_2.bias"] = f"model.22.{branch}.{li}.2.bias"
    return names


def convert_ultralytics_yolov8(state_dict, num_classes: int, scale: str = "n", reg_max: int = 16,
                               device=None) -> YoloV8:
    """An ultralytics ``DetectionModel`` ``state_dict`` (keys ``model.{i}.*``)
    -> a :class:`YoloV8` on ``device`` (None: the GPU) holding its weights.
    The DFL conv (fixed ``arange`` weights) and BatchNorm's
    ``num_batches_tracked`` are not carried: the port computes the former
    and has no use for the latter."""
    model = YoloV8(num_classes, scale, reg_max, device=device)
    target = model.state_dict()
    names = _ultralytics_names(yolov8_widths(scale))
    missing = sorted(set(target) - set(names))
    if missing:
        raise KeyError(f"no ultralytics key for {missing[:5]}")
    loaded = {}
    for ours, theirs in names.items():
        value = torch.as_tensor(state_dict[theirs]).detach().to("cpu", torch.float32)
        if value.shape != target[ours].shape:
            raise ValueError(f"{theirs}: shape {tuple(value.shape)}, the model's {ours} is {tuple(target[ours].shape)}")
        loaded[ours] = value
    model.load_state_dict(loaded)
    return model


_ADAPTER_PROGRAMS = 8  # graphs an adapter keeps (image shapes and thresholds), least recently used dropped


class YoloV8JaxAdapter:
    """``adapter(image, predict_conf) -> DetectionResult`` over a
    :class:`YoloV8` (the JAX package's name): best-class confidence above
    ``predict_conf``, then class-offset NMS on xyxy boxes (ultralytics'
    postprocess). ``logits`` carries the survivors' log class scores (what
    ``yolo_get_logits`` recovers), ``raw_prediction`` the (1, 4 + nc, N)
    head tensor, ``fmaps`` the requested taps as NCHW views on the card.

    The NMS runs on the device over every anchor, the non-candidates given
    a score of -inf: they sort after every candidate, so they suppress
    nothing, and the candidates' order and keep mask are those of an NMS
    over the candidates alone. No step of it reads the host, so on a GPU the
    forward, the selection and the NMS kernel replay as one CUDA graph per
    (image shape, ``predict_conf``) (``use_graph``; False runs them eagerly),
    the port's counterpart of the JAX adapter's jitted forward. The
    predictions, the order and the keep mask then come to the host in one
    copy, the one wait a call makes.
    """

    def __init__(self, model: YoloV8, fmap_taps: Sequence[str] = ("backbone_p5",), iou_threshold: float = 0.7,
                 max_det: int = 300, max_wh: int = 7680, use_graph: bool = True):
        self.model = model
        self.fmap_taps = tuple(fmap_taps)
        self.iou_threshold = float(iou_threshold)
        self.max_det = int(max_det)
        self.max_wh = int(max_wh)
        self.use_graph = use_graph
        self._programs = ProgramCache(_ADAPTER_PROGRAMS)

    def _select(self, images: torch.Tensor, predict_conf: float) -> tuple:
        """The device part of a call: (predictions, order, keep, candidates,
        xyxy boxes, the requested NHWC taps...)."""
        preds, taps = self.model(images)
        pred = preds[0].T  # (N, 4 + nc)
        conf, classes = pred[:, 4:].max(dim=1)
        sel = conf > predict_conf
        cx, cy, w, h = pred[:, 0], pred[:, 1], pred[:, 2], pred[:, 3]
        xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
        offset = classes[:, None].to(torch.float32) * self.max_wh
        order = torch.sort(torch.where(sel, conf, -torch.inf), descending=True, stable=True).indices
        keep = nms_keep((xyxy + offset)[order], self.iou_threshold)
        return (preds, order, keep, sel, xyxy, *(taps[name] for name in self.fmap_taps))

    @torch.inference_mode()
    def __call__(self, image, predict_conf: float = 0.25, **kw) -> DetectionResult:
        device = next(self.model.parameters()).device
        x = as_tensor(image, device, torch.float32)
        if x.ndim == 3:
            x = x[None]
        x = x.to(device)
        img_h, img_w = int(x.shape[1]), int(x.shape[2])
        if self.use_graph and x.is_cuda:
            graph = self._programs.get_or_build(
                (tuple(x.shape), float(predict_conf)),
                lambda: CudaGraph(lambda images: self._select(images, predict_conf), {"images": x}, device=device))
            graph.load(images=x)
            out = graph.replay()
            taps = [t.clone() for t in out[5:]]
        else:
            out = self._select(x, predict_conf)
            taps = out[5:]
        preds_np, order_np, keep_np, sel_np, xyxy_np = copy_to_host(*out[:5])

        kept = order_np[keep_np & sel_np[order_np]][: self.max_det]  # anchor indices, by descending score
        cls = preds_np[0].T[:, 4:]
        return DetectionResult(
            boxes=xyxy_np[kept],
            img_shape=(img_h, img_w),
            scores=cls.max(1)[kept],
            classes=cls.argmax(1)[kept].astype(np.int64),
            logits=np.log(np.clip(cls[kept], 1e-12, None)),
            features=None,
            fmaps=[t.permute(0, 3, 1, 2) for t in taps],
            raw_prediction=preds_np,
        )
