"""Training engine of the PyTorch port: the optimizer and the trainer."""
