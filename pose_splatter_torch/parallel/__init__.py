"""Multi-rank training over ``torch.distributed`` (counterpart of
``pose_splatter_tpu/parallel``): rank meshes, data-parallel steps,
per-rank frame loading and the scaling harness; tile sharding in
``parallel/tile_sharding.py``, the collectives autograd sees in
``parallel/comm.py`` and a launcher of CPU ranks in ``parallel/launch.py``."""

from pose_splatter_torch.parallel.mesh import make_mesh  # noqa: F401
from pose_splatter_torch.parallel.multihost import (  # noqa: F401
    assemble_global_batch,
    global_mesh,
    initialize_distributed,
    measure_steps_per_s,
    process_local_indices,
    scaling_report,
)
from pose_splatter_torch.parallel.sharding import (  # noqa: F401
    make_sharded_train_step,
    replicate_state,
    shard_batch,
)
