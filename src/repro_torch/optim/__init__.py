"""AdamW as plain functions on trees of tensors (the reference's
`repro.optim`)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, apply_masks,
                    global_norm, lr_at, value_and_grad)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "apply_masks",
           "global_norm", "lr_at", "value_and_grad"]
