"""Optimizers of the port (``repro/optim``): AdamW with f32, bf16 or int8
moments, schedules, global-norm clip, int8 error-feedback gradient
compression."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_schedule
from repro_torch.optim import compression, quantized_state  # noqa: F401

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "linear_schedule",
           "compression", "quantized_state"]
