"""A toy kernel wrapper whose ctypes mirror matches its C struct."""

import ctypes
import functools

import torch


def toy_plain(x: torch.Tensor, scale: float) -> torch.Tensor:
    return x * scale


class _ToyArgs(ctypes.Structure):
    """Mirror of ``struct ToyArgs`` in csrc/toy.cuh."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "out")] + [
        ("scratch", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("n", "bf16")] + [
        ("scale", ctypes.c_float)]


@functools.cache
def _lib() -> ctypes.CDLL:
    from cst_captioning_tpu_torch.ops import build

    lib = build.load("toy")
    lib.toy_launch.argtypes = [ctypes.POINTER(_ToyArgs), ctypes.c_void_p]
    lib.toy_launch.restype = ctypes.c_int
    lib.toy_scratch_floats.argtypes = [ctypes.POINTER(_ToyArgs)]
    lib.toy_scratch_floats.restype = ctypes.c_longlong
    return lib


def toy(x: torch.Tensor, scale: float) -> torch.Tensor:
    if x.device.type != "cuda":
        return toy_plain(x, scale)
    out = torch.empty_like(x)
    args = _ToyArgs(x.data_ptr(), out.data_ptr(), 0, x.numel(), 0, scale)
    rc = _lib().toy_launch(ctypes.byref(args), None)
    if rc:
        raise RuntimeError(f"toy_launch failed: {rc}")
    return out
