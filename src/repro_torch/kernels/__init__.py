"""Hand-written Hopper kernels of the serving hot path, with their plain
PyTorch versions (``ref``) and the entry points the model calls (``ops``)."""
