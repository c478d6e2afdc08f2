"""Multi-device execution of the PyTorch port on ``torch.distributed`` (one
process per GPU; NCCL on the GPU, gloo on the CPU): meshes, sharded fitting
and scoring, a data- and head-parallel training step, and the
model-parallel layer: FSDP (``fsdp.py``), tensor-parallel Llama serving
(``llama_tp.py``), sequence-parallel ring attention (``ring_attention.py``),
GPipe pipelining (``pipeline.py``) and expert-parallel MoE (``moe.py``).
"""

from runia_core_tpu_torch.parallel.fsdp import (
    fsdp_shard_params,
    fsdp_spec,
    fsdp_train_step,
)
from runia_core_tpu_torch.parallel.llama_tp import llama_tp_specs, shard_llama_params
from runia_core_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
    sharded_train_step,
)
from runia_core_tpu_torch.parallel.moe import (
    MoEParams,
    init_moe,
    moe_ffn,
    sharded_moe_ffn,
)
from runia_core_tpu_torch.parallel.pipeline import pipeline_apply
from runia_core_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_self_attention,
)
from runia_core_tpu_torch.parallel.sharded import (
    data_parallel_scorer,
    fit_md_sharded,
    fit_pca_sharded,
    sharded_kde_log_density,
    sharded_knn_score,
    sharded_mean_and_covariance,
)

__all__ = [
    "data_parallel_scorer",
    "fit_md_sharded",
    "fit_pca_sharded",
    "sharded_kde_log_density",
    "sharded_knn_score",
    "sharded_mean_and_covariance",
    "fsdp_shard_params",
    "fsdp_spec",
    "fsdp_train_step",
    "initialize_distributed",
    "make_mesh",
    "shard_batch",
    "replicate",
    "sharded_train_step",
    "ring_attention",
    "ring_self_attention",
    "MoEParams",
    "init_moe",
    "moe_ffn",
    "sharded_moe_ffn",
    "pipeline_apply",
    "llama_tp_specs",
    "shard_llama_params",
]
