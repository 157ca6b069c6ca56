"""The port's ops: hand-written CUDA kernels for Hopper, each with its
plain PyTorch version beside it (``bolt_tpu_torch/ops/kernels.py``; the
map functions of ``fused_map_reduce`` compile to expression programs in
``ops/mapexpr.py``), the halo-overlap filters (``ops/overlap.py``) and the
per-record series transforms (``ops/series.py``)."""

from bolt_tpu_torch.ops.kernels import (fused_decode_sum, fused_map_reduce,
                                        fused_stats, fused_welford,
                                        lane_band, sepfilter1d)
from bolt_tpu_torch.ops.overlap import (convolve, gaussian, map_overlap,
                                        median_filter, smooth)
from bolt_tpu_torch.ops.series import (center, crosscorr, detrend, fourier,
                                       normalize, zscore)

__all__ = ["center", "convolve", "crosscorr", "detrend", "fourier",
           "fused_decode_sum", "fused_map_reduce", "fused_stats",
           "fused_welford", "gaussian",
           "lane_band", "map_overlap", "median_filter", "normalize",
           "sepfilter1d", "smooth", "zscore"]
