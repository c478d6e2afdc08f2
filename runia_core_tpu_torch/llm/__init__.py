"""LLM uncertainty of the PyTorch port: the TorchGenerator decode backend and
speculative decoding (SpeculativeGenerator), the scores that read their
output, the NLI judges of semantic entropy, and the streaming attention
aggregator."""

from runia_core_tpu_torch.llm.attention import StreamingAttentionAggregator

from runia_core_tpu_torch.llm.generate import (
    TorchGenerator,
    filter_logits,
    run_generation,
    sample_logits,
    validate_generation_request,
)
from runia_core_tpu_torch.llm.scores import (
    RAUQ,
    batched_rauq,
    compute_uncertainties,
    eigen_score,
    eigen_score_from_embeddings,
    generation_entropy,
    normalized_entropy,
    perplexity,
    rauq_uncertainty,
    rauq_uncertainty_mean_heads,
    rauq_uncertainty_rollout,
    semantic_entropy,
)
from runia_core_tpu_torch.llm.speculative import SpeculativeGenerator, speculative_sample_round
from runia_core_tpu_torch.llm.utils import make_nli_batch_labels, make_nli_equivalence

__all__ = [
    "RAUQ",
    "SpeculativeGenerator",
    "StreamingAttentionAggregator",
    "TorchGenerator",
    "batched_rauq",
    "compute_uncertainties",
    "eigen_score",
    "eigen_score_from_embeddings",
    "filter_logits",
    "generation_entropy",
    "make_nli_batch_labels",
    "make_nli_equivalence",
    "normalized_entropy",
    "perplexity",
    "rauq_uncertainty",
    "rauq_uncertainty_mean_heads",
    "rauq_uncertainty_rollout",
    "run_generation",
    "sample_logits",
    "semantic_entropy",
    "speculative_sample_round",
    "validate_generation_request",
]
