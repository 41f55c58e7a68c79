from repro_torch.distributed.multiprocess import (  # noqa: F401
    GlobalBatchFn,
    as_global_batch_fn,
    is_primary,
    process_count,
    process_index,
)
from repro_torch.distributed.reduce import (  # noqa: F401
    DenseReduce,
    GradReduce,
    HierarchicalInt8EF,
    make_grad_reduce,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    RULES,
    SERVE_RULES,
    batch_shardings,
    data_shard_index,
    logical_spec,
)
