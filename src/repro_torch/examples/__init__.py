"""The reference's examples on the port (``python -m
repro_torch.examples.<name>``): ``quickstart``, ``serve_batched``,
``flocking_analysis`` and ``train_lm``, with ``common.trained_tiny``,
the tiny LM they serve."""
