"""Training utilities of the port: the reference's AdamW, cosine
schedule, global-norm clipping and dynamic loss scaler, term for term,
and flat-npz checkpoints (:mod:`repro_torch.training.checkpoint`)."""
from repro_torch.training.optimizer import (  # noqa: F401
    DynamicLossScaler, clip_by_global_norm, cosine_schedule, global_norm,
    make_adamw, named_leaves, tree_map)
