"""Multi-device execution of the PyTorch port on ``torch.distributed``:
meshes, sharded fitting and scoring, and a data- and head-parallel training
step (one process per GPU; NCCL on the GPU, gloo on the CPU).

The JAX package's model-parallel pieces, ``fsdp.py``, ``llama_tp.py``,
``ring_attention.py``, ``pipeline.py`` and ``moe.py``, have no port yet.
"""

from runia_core_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
    sharded_train_step,
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
    "initialize_distributed",
    "make_mesh",
    "replicate",
    "shard_batch",
    "sharded_kde_log_density",
    "sharded_knn_score",
    "sharded_mean_and_covariance",
    "sharded_train_step",
]
