"""Data layer of the port: rasters and NetCDF I/O, windowed tiles, and the
model's conditioning inputs."""

from deepbedmap_tpu_torch.data.raster import Raster, read_netcdf, write_netcdf  # noqa: F401
