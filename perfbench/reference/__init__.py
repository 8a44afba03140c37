"""Plain PyTorch references of the configurations. They import nothing of
``repro_torch``, ``repro`` or ``jax``, and take only weights that the
benchmark made."""
