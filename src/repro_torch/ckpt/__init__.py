"""Checkpoints (the port's ``repro/ckpt``): save, find and restore a
``TrainState`` in the JAX package's on-disk layout."""
