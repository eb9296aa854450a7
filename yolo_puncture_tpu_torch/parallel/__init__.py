"""Data and tensor parallelism over ``torch.distributed`` (``mesh.py``), and the
DP×TP dry run (``dryrun.py``)."""

from yolo_puncture_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    replicate,
    param_shardings,
    data_parallel_step,
)
