"""Models of the PyTorch port: ResNets and ViTs returning (logits, taps),
their int8 PTQ (``quant_vision``) and torchvision / HF converters, the
decoder LMs with their KV cache and HF converters (the Llama family, dense or
sparse-MoE; GPT-2's ``CausalLM``; GPT-NeoX / Pythia's ``NeoXLM``), and the
DeBERTa-v2 NLI classifier; the detectors (``SimpleDetector``, ``YoloV8``,
``DETR`` and their adapters); the segmentation models (``DeepLabV3Plus`` with
its ``ASPP``, ``SimpleSegmenter``)."""

from runia_core_tpu_torch.models.convert import (
    causal_lm_from_flax,
    deberta_from_flax,
    deeplab_from_flax,
    detector_state_from_arrays,
    detr_from_flax,
    llama_from_flax,
    neox_from_flax,
    pca_state_from_arrays,
    resnet_from_flax,
    segmenter_from_flax,
    simple_detector_from_flax,
    vit_from_flax,
    yolov8_from_flax,
)
from runia_core_tpu_torch.models.deeplab import ASPP, DeepLabV3Plus
from runia_core_tpu_torch.models.deberta import DebertaV2Classifier, convert_hf_deberta, wrap_torch_nli
from runia_core_tpu_torch.models.llama import (
    LlamaLM,
    QDense,
    convert_hf_gemma,
    convert_hf_llama,
    convert_hf_mixtral,
    fuse_quantized_llama_params,
    quantize_llama_params,
)
from runia_core_tpu_torch.models.neox import NeoXLM, convert_hf_gpt_neox
from runia_core_tpu_torch.models.quant_vision import quantize_resnet, quantize_resnet_params
from runia_core_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    SimpleConvNet,
    build_tapped_forward,
    space_to_depth_2x2,
    stem_to_s2d,
)
from runia_core_tpu_torch.models.torch_convert import convert_hf_vit, convert_torch_resnet
from runia_core_tpu_torch.models.transformer import CausalLM, convert_hf_gpt2, init_cache
from runia_core_tpu_torch.models.vit import ViT
from runia_core_tpu_torch.models.detection import JaxDetectorAdapter, SimpleDetector
from runia_core_tpu_torch.models.detr import DETR, DetrAdapter, DetrJaxAdapter, convert_hf_detr
from runia_core_tpu_torch.models.segmentation import SimpleSegmenter
from runia_core_tpu_torch.models.yolov8 import YoloV8, YoloV8JaxAdapter, convert_ultralytics_yolov8, yolov8_widths

__all__ = [
    "ASPP",
    "CausalLM",
    "DETR",
    "DebertaV2Classifier",
    "DeepLabV3Plus",
    "DetrAdapter",
    "DetrJaxAdapter",
    "JaxDetectorAdapter",
    "LlamaLM",
    "NeoXLM",
    "QDense",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "SimpleConvNet",
    "SimpleDetector",
    "SimpleSegmenter",
    "ViT",
    "YoloV8",
    "YoloV8JaxAdapter",
    "build_tapped_forward",
    "causal_lm_from_flax",
    "convert_hf_deberta",
    "convert_hf_detr",
    "convert_hf_gemma",
    "convert_hf_gpt2",
    "convert_hf_gpt_neox",
    "convert_hf_llama",
    "convert_hf_mixtral",
    "convert_hf_vit",
    "convert_torch_resnet",
    "convert_ultralytics_yolov8",
    "deberta_from_flax",
    "deeplab_from_flax",
    "detector_state_from_arrays",
    "detr_from_flax",
    "fuse_quantized_llama_params",
    "init_cache",
    "llama_from_flax",
    "neox_from_flax",
    "pca_state_from_arrays",
    "quantize_llama_params",
    "quantize_resnet",
    "quantize_resnet_params",
    "resnet_from_flax",
    "segmenter_from_flax",
    "simple_detector_from_flax",
    "space_to_depth_2x2",
    "stem_to_s2d",
    "vit_from_flax",
    "yolov8_from_flax",
    "yolov8_widths",
    "wrap_torch_nli",
]
