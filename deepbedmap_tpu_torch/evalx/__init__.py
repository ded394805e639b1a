"""Evaluation: point-track sampling and error metrics (reference L6).

The reference samples predicted grids at survey xyz points with GMT's
``grdtrack`` and reports RMSE (deepbedmap.py:530-573, srgan_train.py:1422-1466).
Here ``grdtrack`` samples a Raster's grid on a device,
``make_fixed_evaluator`` scores a generator on one fixed test region, and
``bicubic_upsample`` / ``bilinear_resample`` make the classical baselines
the paper scores DeepBedMap against.
"""

from deepbedmap_tpu_torch.evalx.baselines import (  # noqa: F401
    bicubic_upsample,
    bilinear_resample,
)
from deepbedmap_tpu_torch.evalx.fixed import make_fixed_evaluator  # noqa: F401
from deepbedmap_tpu_torch.evalx.track import (  # noqa: F401
    elevation_residuals,
    grdtrack,
    read_track_csv,
    track_rmse,
)
