"""deepbedmap_tpu_torch: the PyTorch + CUDA port of ``deepbedmap_tpu``.

The JAX package stays the reference; this package runs the same models on an
NVIDIA H100. It imports torch and numpy only, never JAX. Layout mirrors the
JAX package:

- ``config``    : Generator/Discriminator/Loss/Train/Inference/TilingConfig
                  (copied field for field); SwinIRConfig and HATConfig (the
                  port's own)
- ``ops``       : resize, dense block (K1, K6) and whole RRDB (K4, K5), fused
                  3x3 conv (K10), deformable conv (K7, K8, K9) and fused tail
                  (K2, K3), Swin's shifted-window attention
                  (``ops.window_attn``), the CUDA build and binding
                  (``ops._kernels``);
                  grid sampling (``ops.interp``), metrics (``ops.metrics``),
                  losses and SSIM (``ops.losses``, ``ops.ssim``), the
                  kernels' gradients (``ops._autograd``), and the gridders:
                  the tension-spline relaxation on the device
                  (``ops.spline``) and the exact GMT-surface solve on the
                  host (``ops.gmt_surface``)
- ``csrc``      : the hand-written CUDA C++ kernels (sm_90a)
- ``models``    : generator building blocks, the generator, SwinIR and HAT
                  as second and third generators (``models.swinir``,
                  ``models.hat``) and the
                  discriminator; NCHW helpers (``models.api``)
- ``bridge``    : JAX flax params <-> the port's state_dict
- ``train``     : the GAN's train state, steps, epoch loop and ``fit``;
                  train-state checkpoints and Chainer-npz weights
- ``utils``     : experiment trackers and the weight fetcher (``utils.tracking``),
                  torch.profiler traces and timers (``utils.profiling``),
                  analytic FLOP counts and the H100's peaks (``utils.flops``),
                  JSONL/CSV metric logs (``utils.logging``)
- ``inference`` : halo'd tile engine, band-streamed continent inference and
                  the streamed int16 GeoTIFF product
- ``data``      : data prep (survey ascii ``data.pipeline``, blockmedian
                  and gridding ``data.gridder``, windows and polygons
                  ``data.windows`` / ``data.geojson``, the training arrays
                  ``data.builder``), the training tiles (``data.dataset``),
                  Raster, NetCDF and GeoTIFF I/O (``data.geotiff``, its
                  native LZW codec ``native/tiffcodec.cc``), ``selective_tile``,
                  the model's inputs for one region (``data.groundtruth``)
- ``evalx``     : grdtrack-style track sampling, track RMSE, track CSVs, the
                  fixed-area evaluator, the bicubic and bilinear baselines
                  (``evalx.baselines``)
- ``viz``       : terrain analysis (roughness, hillshade) on a device, the
                  paper's figures, live training curves and the figure set
                  (matplotlib imported only where a figure is drawn)
- ``api``       : DeepBedMap
- ``serve``     : the HTTP inference service
- ``cli``       : ``python -m deepbedmap_tpu_torch`` (grid, build, train,
                  hpo, predict, evaluate, continent, verify-weights, serve,
                  verify-data, package-data, catalog, figures)
- ``device``    : the entry points' device (the card by default)
"""

__version__ = "0.1.0"

from deepbedmap_tpu_torch.config import (  # noqa: F401
    DiscriminatorConfig,
    GeneratorConfig,
    HATConfig,
    InferenceConfig,
    LossConfig,
    SwinIRConfig,
    TrainConfig,
)
from deepbedmap_tpu_torch.api import DeepBedMap  # noqa: F401
