"""Shared set-up of the PyTorch port's tests (``tests/test_torch_*.py``).

Those modules load torch and the port only from a module-scoped fixture,
through :func:`load_torch`, never when they are imported: collecting the
test suite loads no torch, so a pytest-xdist worker that runs only JAX
tests never has torch in its process.
"""


def load_torch():
    """Import torch and pin its intra-op pool to one thread, once per
    process, so that the xdist workers do not oversubscribe the CPU that
    the JAX tests share; returns the module."""
    import torch
    if torch.get_num_threads() != 1:
        torch.set_num_threads(1)
    return torch
