"""Command-line entry points: ``python -m cst_captioning_tpu_torch.cli.train``
and ``python -m cst_captioning_tpu_torch.cli.eval``."""
