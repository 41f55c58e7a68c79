from repro_torch.checkpoint.store import ObjectStore, leaf_digest  # noqa: F401
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    restore_tree,
    save_tree,
)
