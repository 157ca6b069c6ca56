"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (``bolt_tpu_torch/ops/kernels.py``)."""

from bolt_tpu_torch.ops.kernels import fused_stats, fused_welford

__all__ = ["fused_stats", "fused_welford"]
