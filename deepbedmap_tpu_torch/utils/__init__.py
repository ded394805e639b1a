"""Utilities of the port: profiling (``profiling``), metric logging
(``logging``), FLOP accounting (``flops``) and experiment tracking
(``tracking``)."""

from deepbedmap_tpu_torch.utils.logging import MetricLogger  # noqa: F401
from deepbedmap_tpu_torch.utils.profiling import timed, trace  # noqa: F401
from deepbedmap_tpu_torch.utils.tracking import (  # noqa: F401
    HTTPTracker,
    LocalTracker,
    MultiTracker,
    Tracker,
    download_model_weights,
)
