"""Parallelism over ``torch.distributed``, one process per card.

Counterpart of ``deepbedmap_tpu/parallel``. JAX shards over the chips one
process drives and lets GSPMD insert the collectives; the port's mesh is a
``DeviceMesh`` over the process group's ranks, and its collectives are
written out:

- data-parallel training (``make_sharded_train_step``): each rank takes its
  contiguous rows of the global batch; BatchNorm statistics, RaGAN means,
  accuracy and PSNR are the global batch's, and the ranks average their
  gradients, so the step equals the single-device step on the global batch;
- tile-parallel inference (``sharded_predict_tiles``): a band's tiles split
  over the ranks, each holding the whole inputs, then one all-gather;
- tensor (channel) parallelism (``parallel.tp``): convolutions sharded on
  their output channels over the ``"model"`` axis of a 2-D
  ``("data", "model")`` mesh, their outputs all-gathered before the next
  layer reads them.

``parallel.distributed.initialize`` starts the group (torchrun's variables
or an explicit address, world size and rank).
"""

from deepbedmap_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated,
)
from deepbedmap_tpu_torch.parallel.api import (  # noqa: F401
    make_sharded_train_step,
    sharded_predict_tiles,
    stitch_tiles,
)
from deepbedmap_tpu_torch.parallel.tp import (  # noqa: F401
    make_mesh_2d,
    make_tp_forward,
    shard_params_tp,
    tp_param_shardings,
    tp_state_shardings,
)
