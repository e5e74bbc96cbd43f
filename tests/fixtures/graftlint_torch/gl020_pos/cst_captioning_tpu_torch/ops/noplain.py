"""A wrapper module that binds a kernel and keeps no plain version."""

import ctypes
import functools


@functools.cache
def _lib() -> ctypes.CDLL:
    from cst_captioning_tpu_torch.ops import build

    return build.load("toy")
