"""Cell detection: mean-shift localization on stitched seg masks, the
WSI/ROI detection loop and its point metrics."""

from cellsegmentation_tpu_torch.detect.cluster import meanshift_cluster, vectorized_meanshift
from cellsegmentation_tpu_torch.detect.detect import cell_detect
from cellsegmentation_tpu_torch.detect.metrics import AverageMeter, MetricGroup, get_prf1

__all__ = [
    "meanshift_cluster",
    "vectorized_meanshift",
    "AverageMeter",
    "MetricGroup",
    "get_prf1",
    "cell_detect",
]
