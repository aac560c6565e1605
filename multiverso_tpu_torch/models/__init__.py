"""models subpackage of the PyTorch port."""
