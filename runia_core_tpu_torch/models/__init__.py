"""Models of the PyTorch port: ResNets returning (logits, taps), the
decoder LMs with their KV cache and HF converters (the Llama family, dense or
sparse-MoE; GPT-2's ``CausalLM``; GPT-NeoX / Pythia's ``NeoXLM``), and the
DeBERTa-v2 NLI classifier."""

from runia_core_tpu_torch.models.convert import (
    causal_lm_from_flax,
    deberta_from_flax,
    detector_state_from_arrays,
    llama_from_flax,
    neox_from_flax,
    pca_state_from_arrays,
    resnet_from_flax,
)
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
from runia_core_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    build_tapped_forward,
)
from runia_core_tpu_torch.models.transformer import CausalLM, convert_hf_gpt2, init_cache

__all__ = [
    "CausalLM",
    "DebertaV2Classifier",
    "LlamaLM",
    "NeoXLM",
    "QDense",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "build_tapped_forward",
    "causal_lm_from_flax",
    "convert_hf_deberta",
    "convert_hf_gemma",
    "convert_hf_gpt2",
    "convert_hf_gpt_neox",
    "convert_hf_llama",
    "convert_hf_mixtral",
    "deberta_from_flax",
    "detector_state_from_arrays",
    "fuse_quantized_llama_params",
    "init_cache",
    "llama_from_flax",
    "neox_from_flax",
    "pca_state_from_arrays",
    "quantize_llama_params",
    "resnet_from_flax",
    "wrap_torch_nli",
]
