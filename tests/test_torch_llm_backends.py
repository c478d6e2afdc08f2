"""``run_generation``'s dispatch in the port against runia_core_tpu's.

The HF backend is torch in both packages: on a tiny local GPT-2 (random
weights, no download) and a whitespace tokenizer, the port's
``run_generation`` returns what JAX's ``_hf_generation`` returns from the
same torch seed (log-probs, texts, the sampled pass), and
``compute_uncertainties`` over it gives JAX's scores. The other two
backends are held in tests/test_torch_generate*.py and
tests/test_torch_speculative*.py; here, that each type reaches its own.
"""

import numpy as np
import pytest
import torch

from runia_core_tpu.llm import compute_uncertainties as jax_compute_uncertainties
from runia_core_tpu.llm.generate import _hf_generation as jax_hf_generation
from runia_core_tpu_torch.llm import SpeculativeGenerator, TorchGenerator, compute_uncertainties, run_generation
from runia_core_tpu_torch.llm import generate
from runia_core_tpu_torch.models import CausalLM

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

EOS = 1


class WhitespaceTokenizer:
    """Token ids written as decimal words: what HF's flow needs of a
    tokenizer (``__call__`` to tensors, ``batch_decode``)."""

    def __call__(self, text, return_tensors="pt"):
        ids = torch.tensor([[int(word) for word in text.split()]])
        return transformers.BatchEncoding({"input_ids": ids, "attention_mask": torch.ones_like(ids)})

    def batch_decode(self, sequences, skip_special_tokens=True):
        return [" ".join(str(int(t)) for t in row if not (skip_special_tokens and int(t) == EOS)) for row in sequences]


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4, eos_token_id=EOS,
                                  bos_token_id=EOS, attn_implementation="eager")
    return transformers.GPT2LMHeadModel(cfg).eval()


GEN_CONFIG = dict(max_new_tokens=5, do_sample=False, pad_token_id=0, eos_token_id=None)


def test_hf_backend_returns_what_jax_returns(hf_model):
    tok, prompt = WhitespaceTokenizer(), "3 17 42 9 11"
    results = []
    for run in (run_generation, jax_hf_generation):
        torch.manual_seed(7)
        results.append(run(hf_model, tok, prompt, transformers.GenerationConfig(**GEN_CONFIG), 3, True))
    (det, samp, text), (jdet, jsamp, jtext) = results
    assert text == jtext and det["input_length"] == jdet["input_length"] == 5
    np.testing.assert_array_equal(det["log_probs"], jdet["log_probs"])
    assert len(det["logits"]) == len(jdet["logits"]) == 5 and len(det["attentions"]) == 5
    np.testing.assert_array_equal(samp["log_probs"], jsamp["log_probs"])
    assert samp["texts"] == jsamp["texts"] and len(samp["hidden_states"]) == len(jsamp["hidden_states"])


def test_compute_uncertainties_over_hf_matches_jax(hf_model):
    requests = [{"method_name": "perplexity"}, {"method_name": "generation_entropy"}, {"method_name": "RAUQ"},
                {"method_name": "normalized_entropy"}]
    results = []
    for compute in (compute_uncertainties, jax_compute_uncertainties):
        torch.manual_seed(3)
        results.append(compute(hf_model, WhitespaceTokenizer(), "5 8 13 21", requests, num_samples=3,
                               gen_config=transformers.GenerationConfig(**GEN_CONFIG)))
    (text, got), (jtext, want) = results
    assert text == jtext and sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(np.asarray(got[name], np.float64), np.asarray(value, np.float64), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_each_backend_type_reaches_its_own(monkeypatch):
    model = CausalLM(vocab_size=32, num_layers=1, num_heads=2, d_model=16, max_len=32, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    seen = []
    for name in ("_torch_generation", "_speculative_generation", "_hf_generation"):
        monkeypatch.setattr(generate, name, lambda *args, _name=name, **kwargs: seen.append(_name))

    class HFLike:
        def generate(self, **kwargs):  # pragma: no cover - dispatch only
            raise AssertionError

    for backend in (TorchGenerator(model), SpeculativeGenerator(model, model), HFLike()):
        run_generation(backend, None, [1, 2], None, 2, needs_sampling=False)
    assert seen == ["_torch_generation", "_speculative_generation", "_hf_generation"]
    with pytest.raises(TypeError, match="TorchGenerator"):
        run_generation(object(), None, [1, 2], None, 2, needs_sampling=False)
