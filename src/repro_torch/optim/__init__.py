"""SGD, AdamW and LR schedules (counterpart of `repro.optim`)."""
