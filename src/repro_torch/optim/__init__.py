"""Optimizers: AdamW with global-norm clipping and LR schedules."""
