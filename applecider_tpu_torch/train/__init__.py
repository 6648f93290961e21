"""Training of the port: the optimizer pieces and the Trainer."""
