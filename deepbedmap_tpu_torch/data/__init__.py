"""Data layer of the port: survey ascii to gridded beds (``pipeline``,
``gridder``), training windows and their polygon filter (``windows``,
``geojson``), the training arrays (``builder``, ``dataset``), rasters,
NetCDF and GeoTIFF I/O, windowed tiles, and the model's conditioning
inputs."""

from deepbedmap_tpu_torch.data.dataset import (  # noqa: F401
    TileDataset,
    epoch_batches,
    train_dev_split,
)
from deepbedmap_tpu_torch.data.raster import (  # noqa: F401
    Raster,
    read_netcdf,
    read_raster,
    write_netcdf,
)
