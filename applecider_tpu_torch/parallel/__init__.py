"""Data-parallel and multi-process training and serving on
``torch.distributed`` (counterpart of ``applecider_tpu/parallel``)."""

from applecider_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
)
