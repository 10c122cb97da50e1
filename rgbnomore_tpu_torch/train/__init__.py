"""Config, the eval step and the eval half of the trainer."""
