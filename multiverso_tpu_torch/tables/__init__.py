"""tables subpackage of the PyTorch port."""
