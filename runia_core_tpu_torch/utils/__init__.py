"""Utilities of the PyTorch port."""

from runia_core_tpu_torch.utils.timing import cuda_graph_time_ms, cuda_time_ms

__all__ = ["cuda_graph_time_ms", "cuda_time_ms"]
