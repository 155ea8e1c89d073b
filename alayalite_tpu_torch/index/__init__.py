"""index of the PyTorch port."""
