"""The port's DeBERTa-v2 NLI classifier against runia_core_tpu's and HF's.

Toy widths (d_model 32, 2 layers, vocab 97). The primary configuration has
deberta-v2-xxlarge-mnli's structure (share_att_key, p2c + c2p, log position
buckets, LayerNormed relative table, the post-layer-0 conv, no absolute
positions); the second flips every one of those switches, as
tests/test_deberta.py does. Tolerances are the JAX tests': logits in f32
within rtol 1e-4 and atol 2e-4 (3e-4 where the log buckets are reached);
padding invariance within rtol 1e-5, atol 2e-5; labels exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.models import convert_hf_deberta as jax_convert_hf_deberta
from runia_core_tpu.models import wrap_jax_nli
from runia_core_tpu_torch.models import DebertaV2Classifier, convert_hf_deberta, deberta_from_flax, wrap_torch_nli

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

RTOL, ATOL, ATOL_LOG_BUCKETS = 1e-4, 2e-4, 3e-4

XXLARGE_STRUCTURE = dict(
    vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
    max_position_embeddings=64, relative_attention=True, position_buckets=8, norm_rel_ebd="layer_norm",
    share_att_key=True, pos_att_type="p2c|c2p", position_biased_input=False, conv_kernel_size=3, conv_act="gelu",
    type_vocab_size=0, num_labels=3, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, pooler_dropout=0.0,
)
# Every structural switch flipped: dedicated position projections, absolute
# positions, token types, no conv, an un-normed relative table, c2p only, no
# buckets, a width projection.
FLIPPED = dict(
    share_att_key=False, position_biased_input=True, type_vocab_size=2, conv_kernel_size=0, norm_rel_ebd="none",
    pos_att_type="c2p", position_buckets=-1, max_relative_positions=16, embedding_size=24,
)


def tiny_hf_deberta(**over):
    torch.manual_seed(0)
    cfg = transformers.DebertaV2Config(**{**XXLARGE_STRUCTURE, **over})
    return transformers.DebertaV2ForSequenceClassification(cfg).eval()


def _inputs(rng, n=3, t=12, pad=True):
    ids = rng.randint(3, 97, (n, t))
    mask = np.ones((n, t), np.int64)
    if pad:
        for i in range(n):  # ragged right padding
            mask[i, t - i * 2:] = 0
            ids[i, t - i * 2:] = 0
    return ids, mask


def _hf_logits(hf, ids, mask, types=None):
    kwargs = {} if types is None else {"token_type_ids": torch.tensor(types)}
    with torch.no_grad():
        return hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask), **kwargs).logits.numpy()


def _port(model, ids, mask, types=None):
    types = None if types is None else torch.tensor(types)
    return model(torch.tensor(ids), torch.tensor(mask), types).numpy()


@pytest.fixture(scope="module")
def converted():
    hf = tiny_hf_deberta()
    model, _ = convert_hf_deberta(hf, device="cpu")
    jax_model, jax_params = jax_convert_hf_deberta(hf)
    return hf, model, jax_model, jax_params


@pytest.mark.parametrize("n,t,atol", [(3, 12, ATOL), (2, 24, ATOL_LOG_BUCKETS)], ids=["t12", "t24_log_buckets"])
def test_hf_converter_matches_hf_and_jax(converted, n, t, atol):
    """t = 24 with 8 buckets: relative positions past +-4 take the log map."""
    hf, model, jax_model, jax_params = converted
    ids, mask = _inputs(np.random.RandomState(t), n=n, t=t)
    got = _port(model, ids, mask)
    np.testing.assert_allclose(got, _hf_logits(hf, ids, mask), rtol=RTOL, atol=atol)
    want = np.asarray(jax_model.apply(jax_params, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("over", [
    {}, FLIPPED,
    dict(relative_attention=False, position_buckets=-1, position_biased_input=True, conv_kernel_size=0,
         norm_rel_ebd="none", pos_att_type=None),
], ids=["xxlarge_structure", "every_switch_flipped", "no_relative_attention"])
def test_flax_weights_carried_across(over):
    """The port on a JAX model's own (randomly initialised) parameters,
    carried by deberta_from_flax, against the JAX forward; and the HF
    converter's model against HF on the same configuration."""
    hf = tiny_hf_deberta(**over)
    jax_model, hf_params = jax_convert_hf_deberta(hf)
    params = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.key(1), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32)))
    port_cfg = {f: getattr(jax_model, f) for f in (
        "vocab_size", "num_labels", "num_layers", "num_heads", "d_model", "intermediate_size",
        "max_position_embeddings", "embedding_size", "type_vocab_size", "position_biased_input",
        "relative_attention", "position_buckets", "max_relative_positions", "norm_rel_ebd", "share_att_key",
        "pos_att_type", "conv_kernel_size", "conv_groups", "conv_act", "hidden_act", "pooler_hidden_act",
        "layer_norm_eps")}
    port = DebertaV2Classifier(**port_cfg, device="cpu")
    port.load_state_dict(deberta_from_flax(params, device="cpu"))
    rng = np.random.RandomState(2)
    ids, mask = _inputs(rng)
    types = rng.randint(0, 2, ids.shape) if jax_model.type_vocab_size else None
    jtypes = None if types is None else jnp.asarray(types)
    want = np.asarray(jax_model.apply(params, jnp.asarray(ids), jnp.asarray(mask), jtypes))
    np.testing.assert_allclose(_port(port, ids, mask, types), want, rtol=RTOL, atol=ATOL)
    converted, _ = convert_hf_deberta(hf, device="cpu")
    np.testing.assert_allclose(_port(converted, ids, mask, types), _hf_logits(hf, ids, mask, types),
                               rtol=RTOL, atol=ATOL)
    want_hf_params = np.asarray(jax_model.apply(hf_params, jnp.asarray(ids), jnp.asarray(mask), jtypes))
    np.testing.assert_allclose(_port(converted, ids, mask, types), want_hf_params, rtol=RTOL, atol=ATOL)


def test_padding_invariance(converted):
    _, model, _, _ = converted
    ids, mask = _inputs(np.random.RandomState(4), n=2, t=10, pad=False)
    short = _port(model, ids, mask)
    padded = _port(model, np.concatenate([ids, np.zeros((2, 6), np.int64)], 1),
                   np.concatenate([mask, np.zeros((2, 6), np.int64)], 1))
    np.testing.assert_allclose(short, padded, rtol=1e-5, atol=2e-5)


def test_bf16_model_runs_in_its_dtype(converted):
    """A bf16 copy keeps f32 LayerNorms and returns f32 logits near the f32
    model's (bf16 rounds each activation to 2^-9 relative)."""
    hf, model, _, _ = converted
    bf16, state = convert_hf_deberta(hf, dtype=torch.bfloat16, device="cpu")
    assert state["layer_0_attn.query_proj.kernel"].dtype == torch.bfloat16
    assert state["layer_0_attn_ln.scale"].dtype == torch.float32 and state["rel_embeddings"].dtype == torch.float32
    ids, mask = _inputs(np.random.RandomState(5))
    got, want = _port(bf16, ids, mask), _port(model, ids, mask)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max())


class _TinyPairTokenizer:
    """An HF-like pair tokenizer over a toy word vocabulary (padding,
    truncation, numpy tensors, token_type_ids), tests/test_deberta.py's."""

    def _encode(self, text):
        import zlib

        return [3 + (zlib.crc32(w.encode()) % 94) for w in text.split()]

    def __call__(self, premises, hypotheses, padding=True, truncation=True, max_length=None, return_tensors="np"):
        rows, types = [], []
        for p, h in zip(premises, hypotheses):
            a, b = self._encode(p), self._encode(h)
            row, tt = [1] + a + [2] + b + [2], [0] * (len(a) + 2) + [1] * (len(b) + 1)
            if max_length and truncation:
                row, tt = row[:max_length], tt[:max_length]
            rows.append(row)
            types.append(tt)
        width = max(len(r) for r in rows)
        out = {k: np.zeros((len(rows), width), np.int64) for k in ("input_ids", "attention_mask", "token_type_ids")}
        for i, (r, tt) in enumerate(zip(rows, types)):
            out["input_ids"][i, : len(r)] = r
            out["attention_mask"][i, : len(r)] = 1
            out["token_type_ids"][i, : len(tt)] = tt
        return out


PREMISES = ["the cat sat", "a dog ran far", "sun is hot", "rain fell hard on the old roof today"]
HYPOTHESES = ["a cat was sitting", "the dog slept", "sun is hot today", "the roof"]


@pytest.mark.parametrize("max_len,buckets", [(32, (16, 32)), (12, (8,))], ids=["bucket16", "truncated_to_12"])
def test_wrap_torch_nli_labels_equal_wrap_jax_nli(converted, max_len, buckets):
    hf, model, jax_model, jax_params = converted
    tok = _TinyPairTokenizer()
    port = wrap_torch_nli(model, tok, max_len=max_len, len_buckets=buckets, batch_bucket=4)
    jax_fn = wrap_jax_nli(jax_model, jax_params, tok, max_len=max_len, len_buckets=buckets, batch_bucket=4)
    assert port.is_batch_labels
    got = port(PREMISES, HYPOTHESES)
    np.testing.assert_array_equal(got, jax_fn(PREMISES, HYPOTHESES))
    logits = port.logits(PREMISES, HYPOTHESES)
    assert logits.shape == (4, 3) and logits.dtype == np.float32
    np.testing.assert_array_equal(got, logits.argmax(1))
    enc = tok(PREMISES, HYPOTHESES, max_length=max_len)
    want = _hf_logits(hf, enc["input_ids"], enc["attention_mask"], enc["token_type_ids"])
    np.testing.assert_allclose(logits, want, rtol=RTOL, atol=ATOL)
