"""Data layer of the port: rasters, NetCDF and GeoTIFF I/O, windowed tiles,
and the model's conditioning inputs."""

from deepbedmap_tpu_torch.data.raster import (  # noqa: F401
    Raster,
    read_netcdf,
    read_raster,
    write_netcdf,
)
