"""Utilities of the PyTorch port."""

from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, host_sync
from runia_core_tpu_torch.utils.timing import cuda_graph_time_ms, cuda_time_ms, device_profile

__all__ = ["CudaGraph", "ProgramCache", "cuda_graph_time_ms", "cuda_time_ms", "device_profile", "host_sync"]
