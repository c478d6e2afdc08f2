"""Faults of the ``llm_uncertainty`` program's timed path, for the CPU
tests: each function breaks it underneath with ``monkeypatch`` and the run
that follows must come out not correct. A cell lists the faults it can
have, by name, in ``tiny/faults/<cell>.json``.

The CPU sizes (``tiny/``) keep what each fault needs to show: prompts of
20-60 tokens over a window of 16, a YaRN ramp over 32 original positions,
4 of 8 experts a token, prefill chunks of 16.
"""

import torch


def _after_build(monkeypatch, change):
    """``change(model)`` on the model the family builds."""
    from portbench.families import mellum

    build = mellum.build_model

    def build_model(*args, **kwargs):
        model = build(*args, **kwargs)
        change(model)
        return model

    monkeypatch.setattr(mellum, "build_model", build_model)


def window_dropped(monkeypatch):
    """The windowed layers attend every earlier key."""
    _after_build(monkeypatch, lambda model: setattr(model, "sliding_window", 1 << 30))


def plain_rope_on_full_layers(monkeypatch):
    """The full layers take plain RoPE at their theta, not YaRN."""
    def change(model):
        model.rope_parameters["full"] = {"rope_theta": model.rope_parameters["full"]["rope_theta"]}

    _after_build(monkeypatch, change)


def yarn_attention_factor_dropped(monkeypatch):
    """YaRN's frequencies without its scale on cos and sin."""
    def change(model):
        model.rope_parameters["full"] = dict(model.rope_parameters["full"], attention_factor=1.0)

    _after_build(monkeypatch, change)


def _routing(monkeypatch, change):
    from runia_core_tpu_torch.models import llama

    route = llama._route

    def routed(logits, k):
        return change(*route(logits, k))

    monkeypatch.setattr(llama, "_route", routed)


def top_k_not_renormalised(monkeypatch):
    """Each token's top-k router probabilities used as they are."""
    from runia_core_tpu_torch.models import llama

    def route(logits, k):
        top_v, top_i = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
        return top_v, top_i

    monkeypatch.setattr(llama, "_route", route)


def eighth_expert_dropped(monkeypatch):
    """Each token's last chosen expert (the 8th at the published k) weighs 0."""
    def change(top_v, top_i):
        top_v = top_v.clone()
        top_v[:, -1] = 0.0
        return top_v, top_i

    _routing(monkeypatch, change)


def chunk_kv_one_position_off(monkeypatch):
    """A prefill chunk's keys and values written one position later."""
    from runia_core_tpu_torch.models import llama

    write = llama._cache_write

    def shifted(buf, val, cache_index):
        if val.shape[1] > 1:
            cache_index = cache_index + 1
        write(buf, val, cache_index)

    monkeypatch.setattr(llama, "_cache_write", shifted)
