"""The port's ops: hand-written CUDA kernels for Hopper, each with its
plain PyTorch version beside it (``bolt_tpu_torch/ops/kernels.py``; the
map functions of ``fused_map_reduce`` compile to expression programs in
``ops/mapexpr.py``), the halo-overlap filters (``ops/overlap.py``), the
per-record series transforms (``ops/series.py``), the Gram-route linear
algebra (``ops/linalg.py``), grouped reductions, ``topk``, ``unique`` and
``bincount`` (``ops/group.py``) and histograms (``ops/hist.py``)."""

from bolt_tpu_torch.ops.group import bincount, segment_reduce, topk, unique
from bolt_tpu_torch.ops.hist import histogram
from bolt_tpu_torch.ops.kernels import (fused_decode_sum, fused_map_reduce,
                                        fused_stats, fused_welford,
                                        lane_band, sepfilter1d)
from bolt_tpu_torch.ops.linalg import (corrcoef, cov, jacobi_eigh, lstsq,
                                       pca, svdvals, tallskinny_pca,
                                       tallskinny_svd, tsqr)
from bolt_tpu_torch.ops.overlap import (convolve, gaussian, map_overlap,
                                        median_filter, smooth)
from bolt_tpu_torch.ops.series import (center, crosscorr, detrend, fourier,
                                       normalize, zscore)

__all__ = ["bincount", "center", "convolve", "corrcoef", "cov",
           "crosscorr", "segment_reduce", "topk", "unique",
           "detrend", "fourier", "fused_decode_sum", "fused_map_reduce",
           "fused_stats", "fused_welford", "gaussian", "sepfilter1d",
           "histogram", "jacobi_eigh", "lane_band", "lstsq", "map_overlap",
           "median_filter", "normalize", "pca", "smooth", "svdvals",
           "tallskinny_pca", "tallskinny_svd", "tsqr", "zscore"]
