"""Config, mixup and loss, the optimizer and schedule, and the trainer."""
