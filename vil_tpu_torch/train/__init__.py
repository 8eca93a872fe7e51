"""Training: losses, optimizers, LR schedules and the train/eval steps."""
