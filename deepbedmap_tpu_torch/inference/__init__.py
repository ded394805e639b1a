"""Tiled inference engine, band-streamed continent inference on one device
or a mesh, and the band-distributed multi-process path."""

from deepbedmap_tpu_torch.inference.continent import (  # noqa: F401
    predict_continent,
    predict_continent_sharded,
    predict_continent_to_geotiff,
    save_continent_dem,
)
from deepbedmap_tpu_torch.inference.engine import (  # noqa: F401
    TilePlan,
    make_tile_forward,
    make_tile_group_forward,
    predict_region,
    predict_region_tiled,
)
from deepbedmap_tpu_torch.inference.multihost import (  # noqa: F401
    predict_continent_multihost,
    predict_continent_multihost_to_geotiff,
)
