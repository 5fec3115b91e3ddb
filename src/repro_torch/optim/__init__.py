"""SGD and LR schedules (counterpart of `repro.optim`)."""
