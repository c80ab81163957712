"""Checkpoints in the reference's on-disk format (``arrays.npz`` +
``manifest.json`` per step), read and written without JAX."""
