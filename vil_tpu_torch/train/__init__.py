"""Training: losses, optimizers, LR schedules, the train/eval steps and the
experiment Trainer."""
