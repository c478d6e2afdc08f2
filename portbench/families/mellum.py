"""The program's Mellum 2, built from a configuration file and the
benchmark's seeded weights: ``runia_core_tpu_torch.models.LlamaLM`` with its
published layer kinds, RoPE by kind, sparse experts and the served dtype.

The configuration's keys are those of the published ``config.json``;
:func:`model_kwargs` maps them onto ``LlamaLM``'s arguments. Every tensor is
drawn as the reference draws it (``reference.mellum.make_weight``: a
generator of its own seeded with (seed, name)), in f32 on the device, and
rounded into the model's parameter one tensor at a time.
"""

from __future__ import annotations

import torch

from portbench.reference import mellum as ref

KINDS = {"full_attention": "full", "sliding_attention": "sliding"}


def model_kwargs(cfg: dict) -> dict:
    """``LlamaLM`` arguments of the configuration (its dtype included)."""
    if not cfg["norm_topk_prob"] or cfg["tie_word_embeddings"] or cfg["attention_bias"]:
        raise NotImplementedError("Mellum as published: norm_topk_prob, untied head, no attention bias")
    if set(cfg["mlp_layer_types"]) != {"sparse"} or cfg["hidden_act"] != "silu":
        raise NotImplementedError("every MLP a sparse SwiGLU, as published")
    rope = {KINDS[kind]: dict(spec) for kind, spec in cfg["rope_parameters"].items()}
    return dict(
        vocab_size=cfg["vocab_size"], num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], d_model=cfg["hidden_size"], hidden_dim=cfg["moe_intermediate_size"],
        max_len=cfg["max_position_embeddings"], head_dim=cfg["head_dim"], rope_theta=float(rope["full"]["rope_theta"]),
        rms_eps=cfg["rms_norm_eps"], dtype=getattr(torch, cfg["dtype"]), sliding_window=cfg["sliding_window"],
        num_experts=cfg["num_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
        layer_types=[KINDS[kind] for kind in cfg["layer_types"]], rope_parameters=rope,
    )


# The reference's tensor names -> the model's parameter names.
def _param_name(name: str) -> str:
    if name == "embed":
        return "embed.embedding"
    if name == "head":
        return "lm_head.kernel"
    _, i, leaf = name.split(".")
    return f"block_{i}.{leaf}" if leaf.startswith("w_") else f"block_{i}.{leaf}.kernel"


@torch.no_grad()
def build_model(cfg: dict, seed: int, device, use_flash: bool = True):
    """The model in eval mode on ``device``, holding the seeded weights."""
    from runia_core_tpu_torch.models.llama import LlamaLM

    model = LlamaLM(**model_kwargs(cfg), use_flash=use_flash, device=device).eval()
    params = dict(model.named_parameters())
    specs = ref.outer_specs(cfg) + [s for i in range(cfg["num_hidden_layers"]) for s in ref.layer_specs(cfg, i)]
    for name, shape, std in specs:
        target = params[_param_name(name)]
        assert tuple(target.shape) == tuple(shape), (name, tuple(target.shape), shape)
        target.copy_(ref.make_weight(seed, name, shape, std, device))
    return model
