"""apps subpackage of the PyTorch port."""
