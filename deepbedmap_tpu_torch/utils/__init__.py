"""Utilities of the port: experiment tracking (``tracking``)."""

from deepbedmap_tpu_torch.utils.tracking import (  # noqa: F401
    HTTPTracker,
    LocalTracker,
    MultiTracker,
    Tracker,
    download_model_weights,
)
