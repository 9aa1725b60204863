"""Training utilities of the port: the reference's AdamW, term for term."""
from repro_torch.training.optimizer import (  # noqa: F401
    clip_by_global_norm, global_norm, make_adamw, named_leaves, tree_map)
