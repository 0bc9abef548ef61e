"""Data parallelism on torch.distributed, one process per device: the
counterpart of beat_this_tpu/parallel/."""

from beat_this_tpu_torch.parallel.distributed import (  # noqa: F401
    host_shard,
    maybe_initialize_distributed,
    rank_device,
)
from beat_this_tpu_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    data_parallel,
    make_group,
    pad_to_multiple,
    shard_rows,
    usable_data_devices,
)
