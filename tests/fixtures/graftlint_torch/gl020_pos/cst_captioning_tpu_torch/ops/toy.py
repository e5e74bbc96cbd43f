"""A toy kernel wrapper whose mirror, signatures and fallback drift."""

import ctypes
import functools

import torch


def toy_plain(x: torch.Tensor, scale: float) -> torch.Tensor:
    return x * scale


class _ToyArgs(ctypes.Structure):
    """Mirror of ``struct ToyArgs`` in csrc/toy.cuh."""

    # "n" and "bf16" are fine; "scale" came before "scratch" (drift)
    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "out")] + [
        ("scale", ctypes.c_float)] + [
        (n, ctypes.c_int) for n in ("n", "bf16")] + [
        ("scratch", ctypes.c_longlong)]


@functools.cache
def _lib() -> ctypes.CDLL:
    from cst_captioning_tpu_torch.ops import build

    lib = build.load("toy")
    lib.toy_launch.argtypes = [ctypes.POINTER(_ToyArgs)]
    lib.toy_launch.restype = ctypes.c_int
    lib.toy_scratch_floats.argtypes = [ctypes.POINTER(_ToyArgs)]
    lib.toy_scratch_floats.restype = ctypes.c_int
    return lib


def toy(x: torch.Tensor, scale: float) -> torch.Tensor:
    out = torch.empty_like(x)
    args = _ToyArgs(x.data_ptr(), out.data_ptr(), scale, x.numel(), 0, 0)
    try:
        _lib().toy_launch(ctypes.byref(args), None)
    except OSError:
        return toy_plain(x, scale)
    return out
