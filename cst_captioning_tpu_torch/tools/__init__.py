"""Developer tooling of the port (no runtime dependencies).

``tools.graftlint`` is the port's static-analysis pass: the JAX package's
graftlint rules retargeted to torch, CUDA tensors, ``torch.distributed``
and the kernels' C interface. Run it as
``python -m cst_captioning_tpu_torch.tools.graftlint``.
"""
