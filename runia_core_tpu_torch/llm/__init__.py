"""LLM uncertainty of the PyTorch port: the TorchGenerator decode backend,
speculative decoding (SpeculativeGenerator), the continuous-batching serving
engine (ContinuousBatchingEngine, plain or speculative, with its fused
offline drain), the serving fronts built on them (UncertaintyServer /
serve_uncertainties, GenerationService), the scores that read their output,
the NLI judges of semantic entropy, and the streaming attention aggregator."""

from runia_core_tpu_torch.llm.attention import StreamingAttentionAggregator
from runia_core_tpu_torch.llm.continuous import ContinuousBatchingEngine, speculative_breakeven
from runia_core_tpu_torch.llm.serve_uncertainty import UncertaintyServer, serve_uncertainties
from runia_core_tpu_torch.llm.service import GenerationService

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
    "ContinuousBatchingEngine",
    "GenerationService",
    "RAUQ",
    "SpeculativeGenerator",
    "StreamingAttentionAggregator",
    "TorchGenerator",
    "UncertaintyServer",
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
    "serve_uncertainties",
    "speculative_breakeven",
    "speculative_sample_round",
    "validate_generation_request",
]
