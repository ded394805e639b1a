"""Generator and discriminator of the port (NHWC activations, OIHW weights)."""

from deepbedmap_tpu_torch.models.api import (  # noqa: F401
    build_discriminator,
    build_generator,
    count_params,
)
from deepbedmap_tpu_torch.models.discriminator import Discriminator  # noqa: F401
from deepbedmap_tpu_torch.models.generator import Generator  # noqa: F401
