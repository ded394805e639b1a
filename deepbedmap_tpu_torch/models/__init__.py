"""Generator and discriminator of the port (NHWC activations, OIHW weights)."""

from deepbedmap_tpu_torch.models.api import (  # noqa: F401
    build_discriminator,
    build_generator,
    count_params,
    example_inputs_nhwc,
    generator_forward_nchw,
    nchw_to_nhwc,
    nhwc_to_nchw,
)
from deepbedmap_tpu_torch.models.discriminator import Discriminator  # noqa: F401
from deepbedmap_tpu_torch.models.generator import Generator  # noqa: F401
from deepbedmap_tpu_torch.models.summary import param_table, summary, to_dot  # noqa: F401
