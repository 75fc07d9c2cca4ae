"""More than one device (counterpart of ``cwfa_tpu/parallel``): one process
per GPU on ``torch.distributed``, the ``data`` mesh axis and the batch shard
of a data-parallel call, the ``space`` axis and the row shard of a call;
see ``distributed``, ``mesh`` and ``halo``."""

from cwfa_tpu_torch.parallel.distributed import (  # noqa: F401
    assemble_global, gather_rows, global_batch_array, host_local_indices,
    initialize_from_env, is_primary, local_device, to_host,
)
from cwfa_tpu_torch.parallel.mesh import (  # noqa: F401
    BatchShard, RowShard, batch_shard, batch_sharding, data_shard,
    draw_rows, make_mesh, replicate, row_shard, space_rows,
)
