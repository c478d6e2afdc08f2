"""Evaluation helpers of the PyTorch port."""

from runia_core_tpu_torch.evaluation.entropy import get_dl_h_z, neighbors_for, single_image_entropy_calculation

__all__ = ["get_dl_h_z", "neighbors_for", "single_image_entropy_calculation"]
