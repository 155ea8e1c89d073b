"""spaces of the PyTorch port."""
