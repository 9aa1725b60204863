"""Training utilities of the port: the reference's AdamW and cosine
schedule, term for term."""
from repro_torch.training.optimizer import (  # noqa: F401
    cosine_schedule, global_norm, make_adamw, named_leaves, tree_map)
