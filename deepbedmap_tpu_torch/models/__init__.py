"""Generator model of the port (NHWC activations, OIHW weights)."""

from deepbedmap_tpu_torch.models.api import build_generator, count_params  # noqa: F401
from deepbedmap_tpu_torch.models.generator import Generator  # noqa: F401
