"""Raster data model of the port."""

from deepbedmap_tpu_torch.data.raster import Raster  # noqa: F401
