"""Tensor ops of the port: plain PyTorch versions and the CUDA kernel wrappers.

The names JAX's ``deepbedmap_tpu.ops`` exports are re-exported here; the
kernels are built at their first launch, never at import.
"""

from deepbedmap_tpu_torch.ops.resize import (  # noqa: F401
    avg_pool,
    nearest_upsample,
    space_to_depth,
)
from deepbedmap_tpu_torch.ops.ssim import ssim  # noqa: F401
from deepbedmap_tpu_torch.ops.metrics import psnr, rmse  # noqa: F401
from deepbedmap_tpu_torch.ops.losses import (  # noqa: F401
    binary_accuracy,
    generator_loss,
    ragan_loss,
    sigmoid_cross_entropy,
)
from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d  # noqa: F401
