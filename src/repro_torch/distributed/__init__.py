from repro_torch.distributed.multiprocess import (  # noqa: F401
    FusedDrainFlag,
    GlobalBatchFn,
    ProcessShard,
    any_process_flag,
    as_global_batch_fn,
    barrier,
    batch_like,
    bind_store,
    is_primary,
    kv_allgather,
    kv_delete,
    kv_delete_stream,
    kv_fetch,
    kv_fetch_stream,
    kv_json_allgather,
    kv_put,
    kv_put_stream,
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
