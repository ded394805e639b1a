"""``python -m deepbedmap_tpu_torch`` — see deepbedmap_tpu_torch.cli."""

import sys

from deepbedmap_tpu_torch.cli import main

sys.exit(main())
