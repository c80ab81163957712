"""Data sources (numpy-only copies of the reference's ``data`` package)."""
