"""Offline analysis tools (port of ``repro/analysis``: sparsity profiles)."""
