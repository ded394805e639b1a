"""Visualization + terrain analysis (reference L8, paper_figures.py).

Counterpart of ``deepbedmap_tpu/viz/__init__.py``, with the same exports.
The reference renders with GMT/PyGMT (C library); here matplotlib covers
maps, hillshades, transects and histograms, and the roughness analysis
(rolling std-dev grids, paper_figures.py:847-998) runs on a device.
Importing this package does not import matplotlib: the functions that draw
import it, so the analysis runs where matplotlib is not installed.
"""

from deepbedmap_tpu_torch.viz.analysis import standard_deviation_2d, hillshade  # noqa: F401
from deepbedmap_tpu_torch.viz.figures import (  # noqa: F401
    plot_dem,
    plot_comparison,
    plot_transect,
    plot_error_histogram,
)
from deepbedmap_tpu_torch.viz.paper import (  # noqa: F401
    REGION_PINE_ISLAND,
    REGION_THWAITES,
    closeup_fig,
    fig_3d_comparison,
    fig_architecture,
    fig_input_thumbnails,
    fig_dem_overview,
    fig_roughness_grids,
    fig_transect,
    plot_3d_view,
)
