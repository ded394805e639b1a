"""Top-level user API of the PyTorch port.

Counterpart of ``deepbedmap_tpu/api.py:DeepBedMap`` (constructors from JAX
params, a Chainer npz or a tracker, ``forward_fn``, single-region ``predict``
and ``track_rmse``, ``predict_continent`` on one device, a mesh of ranks or
with its bands split over processes, buffered or streamed into the GeoTIFF
product):

    from deepbedmap_tpu_torch import DeepBedMap

    dbm = DeepBedMap()                                   # seeded random weights
    dbm = DeepBedMap.from_checkpoint(path)               # the port's train state
    dbm = DeepBedMap.from_jax_params(tree)               # JAX-trained weights
    dbm = DeepBedMap.from_chainer_npz(path)              # reference-format weights
    dbm = DeepBedMap.from_experiment(root_or_url)        # a tracker's weights
    dem = dbm.predict(window_bound, rasters)             # one region -> Raster
    rmse = dbm.track_rmse(dem, x, y, z)
    dem = dbm.predict_continent(inputs, bounds)          # band-streamed -> Raster
    dbm.predict_continent(inputs, bounds, outfilepath="dem",
                          stream_product=True)          # -> dem.tif, int16 LZW

The device defaults to ``"cuda"`` and a missing card raises; pass
``device="cpu"`` for the CPU. On a CUDA device the generator runs the
hand-written kernels. For results that match the fp32 JAX reference, turn
TF32 off in the caller (``device.disable_tf32()``; cuDNN convs default to
TF32). The port's CLI and ``serve.serve_forever`` do so themselves.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from deepbedmap_tpu_torch.bridge import jax_params_to_state_dict
from deepbedmap_tpu_torch.config import GeneratorConfig, HATConfig, SwinIRConfig
from deepbedmap_tpu_torch.data.groundtruth import get_model_inputs
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.evalx.track import track_rmse
from deepbedmap_tpu_torch.inference.continent import (
    predict_continent,
    predict_continent_sharded,
    predict_continent_to_geotiff,
    save_continent_dem,
)
from deepbedmap_tpu_torch.inference.engine import TilePlan
from deepbedmap_tpu_torch.inference.multihost import (
    predict_continent_multihost,
    predict_continent_multihost_to_geotiff,
)
from deepbedmap_tpu_torch.models.api import build_generator, make_generator
from deepbedmap_tpu_torch.parallel.mesh import mesh_rank
from deepbedmap_tpu_torch.utils.profiling import count, span
from deepbedmap_tpu_torch.train.checkpoint import (
    import_chainer_generator_npz,
    load_generator_state_dict,
)
from deepbedmap_tpu_torch.utils.tracking import download_model_weights

Bounds = Tuple[float, float, float, float]  # (xmin, ymin, xmax, ymax)


class DeepBedMap:
    """A trained (or fresh) super-resolution bed-DEM model on one device."""

    def __init__(
        self,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        cfg: Union[GeneratorConfig, SwinIRConfig, HATConfig] = GeneratorConfig(),
        resolution: float = 250.0,
        device="cuda",
    ):
        """``params``: a port ``state_dict``; None draws seeded random
        weights (``models.build_generator``'s default seed). ``cfg`` selects
        the generator: DeepBedMap's for a ``GeneratorConfig``, SwinIR for a
        ``SwinIRConfig`` (``models.swinir``), HAT for a ``HATConfig``
        (``models.hat``), which ``predict_continent`` runs as it runs
        DeepBedMap's (the region, serving and training paths are
        DeepBedMap's alone). ``device``
        defaults to the card and raises where there is none; pass
        ``device="cpu"`` for the CPU. On a CUDA device, widths a forced
        (``'always'``) kernel does not take raise ``NotImplementedError``
        (``check_generator_device``)."""
        self.cfg = cfg
        self.resolution = resolution
        if params is None:
            self.model = build_generator(cfg, device=device)
        else:
            self.model = make_generator(cfg, device)
            self.model.load_state_dict(params)
        self.device = resolve_device(device)
        self.model.to(self.device).eval()

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        cfg: GeneratorConfig = GeneratorConfig(),
        use_ema: bool = True,
        resolution: float = 250.0,
        device="cuda",
    ) -> "DeepBedMap":
        """From a train-state checkpoint of the port
        (``train.checkpoint.save_checkpoint``). ``use_ema``: prefer the EMA
        weights when the run kept them (``TrainConfig.ema_decay > 0``), the
        lower-variance choice for inference. ``cfg`` picks the forward's
        kernel configuration; its depth must be the checkpoint's. A JAX Orbax
        checkpoint raises ``ValueError`` (cross over through
        ``from_chainer_npz``)."""
        resolve_device(device)
        return cls(load_generator_state_dict(path, use_ema), cfg, resolution, device)

    @classmethod
    def from_jax_params(
        cls,
        tree: Mapping,
        cfg: GeneratorConfig = GeneratorConfig(),
        resolution: float = 250.0,
        device="cuda",
    ) -> "DeepBedMap":
        """From the JAX generator's flax params (nested dicts of numpy arrays)."""
        return cls(jax_params_to_state_dict(tree), cfg, resolution, device)

    @classmethod
    def from_chainer_npz(
        cls,
        path: str,
        cfg: GeneratorConfig = GeneratorConfig(),
        offset_order: str = "xy",
        resolution: float = 250.0,
        device="cuda",
    ) -> "DeepBedMap":
        """Load reference-format (Chainer save_npz) generator weights.
        ``offset_order='xy'``: the npz holds the offset convs' x half first
        (``train.checkpoint``)."""
        params = import_chainer_generator_npz(path, cfg.num_residual_blocks, offset_order)
        return cls.from_jax_params(params, cfg, resolution, device)

    @classmethod
    def from_experiment(
        cls,
        source,  # tracker root dir, http(s) base URL, or a Tracker instance
        experiment_key: str = "latest",
        download_path: str = "model/weights/srgan_generator_model_weights.npz",
        api_key: Optional[str] = None,
        asset_name: str = "srgan_generator_model_weights.npz",
        device="cuda",
    ) -> "DeepBedMap":
        """Fetch trained weights by experiment key from a tracker: the
        reference's Comet weight fetcher (features/environment.py:87-127, used
        by deepbedmap.py:381-410). 'latest' resolves to the newest experiment,
        the npz asset is downloaded to ``download_path``, and the run's logged
        num_residual_blocks / residual_scaling rebuild the matching
        generator. The device is checked before anything is fetched."""
        resolve_device(device)
        hp = download_model_weights(
            source,
            experiment_key=experiment_key,
            asset_name=asset_name,
            download_path=download_path,
            api_key=api_key,
        )
        cfg = GeneratorConfig(
            num_residual_blocks=int(hp.get("num_residual_blocks", 12)),
            residual_scaling=float(hp.get("residual_scaling", 0.1)),
        )
        return cls.from_chainer_npz(download_path, cfg, device=device)

    def forward_fn(self):
        """(x, w1, w2, w3) NHWC tensors on ``self.device`` -> NHWC prediction."""
        model = self.model

        def fwd(x, w1, w2, w3):
            with torch.inference_mode():
                return model(x, w1, w2, w3)

        return fwd

    def predict(
        self,
        window_bound: Bounds,
        rasters: Dict[str, Raster],
        padding: float = 1000.0,
    ) -> Raster:
        """Predict one region. ``rasters`` keys: bed_lowres, surface,
        velocity_x, velocity_y, accumulation (the reference's five inputs).
        The inputs are cut on ``self.device`` (``data.groundtruth``) and go
        through the generator unclipped, as in JAX (only
        ``predict_continent`` clips the conditioning). One call is the
        telemetry's ``predict``: ``predict.inputs`` (the ``tiler.*`` spans),
        ``predict.forward``, ``predict.fetch``."""
        with span("predict", range=False):
            count("predict.requests")
            with span("predict.inputs", range=False):
                inputs = get_model_inputs(
                    window_bound,
                    rasters["bed_lowres"],
                    rasters["surface"],
                    rasters["velocity_x"],
                    rasters["velocity_y"],
                    rasters["accumulation"],
                    padding=padding,
                    device=self.device,
                )
            with span("predict.forward"):
                pred = self.forward_fn()(*(inputs[k].permute(0, 2, 3, 1).contiguous()
                                           for k in ("X", "W1", "W2", "W3")))
            with span("predict.fetch"):
                dem = pred[0, :, :, 0].cpu().numpy()
        xmin, ymin, xmax, ymax = window_bound
        return Raster(dem, left=xmin, top=ymax, res=self.resolution)

    def predict_continent(
        self,
        inputs_nchw: Dict[str, np.ndarray],  # X/W1/W2/W3 full-region stacks
        bounds: Bounds,
        outfilepath: Optional[str] = None,
        tile_out: int = 1000,
        halo_lr: int = 18,
        mesh=None,
        stream_product: bool = False,
        tile_loop: str = "scan",
        prefetch: int = 1,
        rows_per_strip: Optional[int] = None,
        overviews: int = 0,
        predictor: bool = False,
        tiles_per_dispatch: int = 2,
        multihost: bool = False,
    ) -> Optional[Raster]:
        """Band-streamed whole-region prediction on ``self.device``;
        optionally writes the int16 LZW GeoTIFF product
        ``{outfilepath}.tif``. Inputs follow the reference NCHW contract,
        unpadded (covering exactly ``bounds``).

        ``stream_product``: pipe strips straight into the GeoTIFF through a
        writer thread (requires ``outfilepath``; returns None, the canvas is
        never materialised, so host memory holds two strips, not the
        region). Without it the canvas is returned and, with
        ``outfilepath``, written afterwards by
        ``save_continent_dem`` (tiled, single page).
        ``tile_loop``: 'scan' or 'host', the same loop here (JAX's signature).
        ``prefetch``: bands dispatched ahead of the blocking fetch (0 = serial).
        ``rows_per_strip``: TIFF strip height for ``stream_product`` (None
        = ~8 uniform sub-strips per band, parallel native LZW encode).
        ``overviews``: with ``stream_product``, append this many 2x pyramid
        levels as chained TIFF pages (nodata-aware average, built
        incrementally; read back via ``read_geotiff(path, page=L)``).
        ``predictor``: with ``stream_product``, TIFF horizontal differencing
        before the LZW (data-dependent; see ``GeoTiffStripWriter``).
        ``tiles_per_dispatch``: tiles batched per forward on the
        single-device paths and the streamed mesh path (JAX's use of it).
        ``mesh``: a ``torch.distributed`` ``DeviceMesh``
        (``parallel.make_mesh``) on the model's device type; every rank of it
        calls this with the same inputs and each band's tiles are split over
        the ranks (``inference.continent.predict_continent_sharded``). Every
        rank computes and returns the Raster; only the mesh's first rank
        writes ``outfilepath``.
        ``multihost``: split the row bands over the processes of the group
        (``inference.multihost``; start it with
        ``parallel.distributed.initialize``). ``mesh`` must then hold this
        rank alone. The Raster (or the product) comes back on rank 0 and None
        elsewhere; world size 1 is the single-device path."""
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                                f"(parallel.make_mesh), got {type(mesh).__name__}")
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a model on {self.device}")
        if (overviews or predictor) and not stream_product:
            raise ValueError(
                "overviews/predictor are features of the streamed writer: "
                "pass stream_product=True (the buffered save_continent_dem "
                "path writes a plain single-page tiled GeoTIFF)"
            )
        if stream_product and outfilepath is None:
            raise ValueError("stream_product needs outfilepath")
        xmin, ymin, xmax, ymax = bounds
        plan = TilePlan(
            out_h=int(round((ymax - ymin) / self.resolution)),
            out_w=int(round((xmax - xmin) / self.resolution)),
            tile_out=tile_out,
            halo_lr=halo_lr,
        )
        host_inputs = {
            k: np.asarray(v).transpose(0, 2, 3, 1) for k, v in inputs_nchw.items()
        }
        if multihost:
            if stream_product:
                predict_continent_multihost_to_geotiff(
                    self.forward_fn(), host_inputs, plan, bounds, outfilepath,
                    mesh=mesh, rows_per_strip=rows_per_strip, overviews=overviews,
                    predictor=predictor, tile_loop=tile_loop, device=self.device,
                )
                return None
            canvas = predict_continent_multihost(
                self.forward_fn(), host_inputs, plan, mesh=mesh, tile_loop=tile_loop,
                device=self.device,
            )
            if canvas is None:  # not rank 0
                return None
            if outfilepath is not None:
                save_continent_dem(canvas, bounds, outfilepath)
            return Raster(canvas, left=xmin, top=ymax, res=self.resolution)
        if stream_product:
            predict_continent_to_geotiff(
                self.forward_fn(), host_inputs, plan, bounds, outfilepath,
                tile_loop=tile_loop, prefetch=prefetch,
                rows_per_strip=rows_per_strip, overviews=overviews,
                predictor=predictor, tiles_per_dispatch=tiles_per_dispatch,
                device=self.device, mesh=mesh,
            )
            return None
        if mesh is not None:
            canvas = predict_continent_sharded(
                self.forward_fn(), host_inputs, plan, mesh, prefetch=prefetch
            )
        else:
            canvas = predict_continent(
                self.forward_fn(), host_inputs, plan, tile_loop=tile_loop,
                prefetch=prefetch, tiles_per_dispatch=tiles_per_dispatch,
                device=self.device,
            )
        if outfilepath is not None and (mesh is None or mesh_rank(mesh) == 0):
            save_continent_dem(canvas, bounds, outfilepath)
        return Raster(canvas, left=xmin, top=ymax, res=self.resolution)

    def track_rmse(
        self, dem: Raster, x: np.ndarray, y: np.ndarray, z: np.ndarray
    ) -> float:
        """Bicubic track RMSE of ``dem`` against xyz points, on
        ``self.device`` (``evalx.track_rmse``)."""
        return track_rmse(dem, x, y, z, device=self.device)
