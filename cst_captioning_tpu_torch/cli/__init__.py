"""Command-line entry points: ``python -m cst_captioning_tpu_torch.cli.train``,
``cli.eval``, the dataset importers ``cli.import_msrvtt`` and
``cli.import_msvd``, and ``cli.preprocess``."""
