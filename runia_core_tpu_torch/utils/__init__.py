"""Utilities of the PyTorch port: CUDA graphs, placement, timing and
profiling, and failure detection."""

from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, host_sync
from runia_core_tpu_torch.utils.health import (
    HealthCheckError,
    NonFiniteError,
    device_healthcheck,
    find_nonfinite,
    guard_finite,
    with_retries,
)
from runia_core_tpu_torch.utils.placement import as_tensor, to_numpy
from runia_core_tpu_torch.utils.profiling import (
    benchmark,
    cuda_profile,
    profile_taps,
    record_time,
    sync,
    trace_annotation,
)
from runia_core_tpu_torch.utils.timing import cuda_graph_time_ms, cuda_time_ms, device_profile

__all__ = [
    "CudaGraph",
    "HealthCheckError",
    "NonFiniteError",
    "ProgramCache",
    "as_tensor",
    "benchmark",
    "cuda_graph_time_ms",
    "cuda_profile",
    "cuda_time_ms",
    "device_healthcheck",
    "device_profile",
    "find_nonfinite",
    "guard_finite",
    "host_sync",
    "profile_taps",
    "record_time",
    "sync",
    "to_numpy",
    "trace_annotation",
    "with_retries",
]
