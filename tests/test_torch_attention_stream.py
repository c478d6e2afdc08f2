"""The port's StreamingAttentionAggregator against runia_core_tpu's and
against the port's dense aggregations, on HF-shaped attentions (numpy in
both packages: equal to 1e-12)."""

import numpy as np
import pytest

from runia_core_tpu.llm.attention import StreamingAttentionAggregator as JaxStreamingAttentionAggregator
from runia_core_tpu_torch.llm import StreamingAttentionAggregator
from runia_core_tpu_torch.llm.attention import (
    _get_attention_rollout,
    _get_average_attention_all,
    _get_recurent_attention,
)

LAYERS, HEADS = 3, 4


def _attentions(rng, p, steps):
    def rows(shape):
        a = rng.rand(*shape)
        return a / a.sum(-1, keepdims=True)

    out = [tuple(np.tril(rows((1, HEADS, p, p))) for _ in range(LAYERS))]
    for k in range(1, steps):
        out.append(tuple(rows((1, HEADS, 1, p + k)) for _ in range(LAYERS)))
    return tuple(out)


def _feed(agg, attentions):
    agg.prefill(attentions[0])
    for step in attentions[1:]:
        agg.step(step)
    return agg


@pytest.mark.parametrize("p,steps", [(7, 5), (3, 1), (12, 9)])
def test_streaming_matches_jax_and_the_dense_aggregations(p, steps):
    attentions = _attentions(np.random.RandomState(p), p, steps)
    got = _feed(StreamingAttentionAggregator(p), attentions)
    want = _feed(JaxStreamingAttentionAggregator(p), attentions)
    for name in ("rollout", "prev_token_attention", "mean_past_attention"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0, err_msg=name)
    np.testing.assert_allclose(got.rollout, _get_attention_rollout(attentions, p), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.mean_past_attention, _get_average_attention_all(attentions), atol=1e-12, rtol=0)
    if steps > 1:
        np.testing.assert_allclose(got.prev_token_attention, _get_recurent_attention(attentions), atol=1e-12, rtol=0)


def test_rollout_tracking_off():
    attentions = _attentions(np.random.RandomState(0), 5, 3)
    agg = _feed(StreamingAttentionAggregator(5, track_rollout=False), attentions)
    np.testing.assert_allclose(agg.mean_past_attention, _get_average_attention_all(attentions), atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="rollout"):
        agg.rollout
    with pytest.raises(ValueError, match="batch 1"):
        StreamingAttentionAggregator(5).prefill([np.ones((2, HEADS, 5, 5))])
