"""Fused masked additive-attention context: the wrapper, its plain PyTorch
version, the autograd rule and the CUDA kernel's binding.

:func:`fused_additive_attention` keeps the argument contract of the JAX
package's TPU kernel of the same name
(``cst_captioning_tpu/ops/attention_pallas.py``):

    q [B, A] (query_proj already applied), v [A] (the score vector),
    memory [B, M, E], memory_proj [B, M, A]   all in the model dtype
    mask [B, M] float32
    -> ctx [B, E] in the memory dtype
    ctx = softmax_f32(where(mask > 0, v . tanh(memory_proj + q), -1e9)) @ memory

On CUDA tensors the forward launches the hand-written kernel
``csrc/additive_attention.cu`` (built by ``ops/build.py``) and counts the
launch in ``fused_additive_attention.launches``; on CPU tensors it runs
:func:`additive_attention_plain`. The backward recomputes the plain version
under autograd, as the JAX op's ``custom_vjp`` recomputes its XLA composite,
so a step with gradients launches the kernel once, in the forward. Nothing
falls back: a CUDA call that cannot launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cst_captioning_tpu_torch.ops.decode_stride import _device_of, _expect

NEG = -1.0e9


def additive_attention_plain(q, v, memory, memory_proj, mask):
    """The JAX op's reference composite, dtype for dtype: the scores are
    summed in the model dtype and masked there, the softmax runs in float32
    and its weights are rounded back to the memory dtype."""
    t = torch.tanh(memory_proj + q[:, None, :])
    s = t @ v.to(t.dtype)                                      # [B, M]
    s = torch.where(mask > 0, s, torch.full_like(s, NEG)).float()
    w = torch.softmax(s, dim=-1).to(memory.dtype)
    return torch.einsum("bm,bme->be", w, memory)


def additive_attention_f32(q, v, memory, memory_proj, mask):
    """The CUDA kernel's own numerics as a float32 composite: ``proj + q``
    and ``tanh`` rounded to the memory dtype, every sum float32, the output
    float32 and not rounded. In bfloat16 the kernel differs from it by its
    one output rounding (at most 2^-8 of the value) and the order of its
    float32 sums; :func:`additive_attention_plain` also rounds the scores
    and weights, so it is the looser reference there."""
    dt = memory.dtype
    x = (memory_proj.float() + q.float()[:, None, :]).to(dt).float()
    t = torch.tanh(x).to(dt).float()
    s = torch.where(mask > 0, t @ v.float(), torch.tensor(NEG))
    return torch.einsum("bm,bme->be", torch.softmax(s, dim=-1), memory.float())


# ---- the kernel's binding ----------------------------------------------------


class _AttentionArgs(ctypes.Structure):
    """Mirror of ``struct AttentionArgs`` in csrc/additive_attention.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "v", "mem", "proj", "mask", "out")] + [
        (n, ctypes.c_int) for n in ("bf16", "B", "M", "A", "E")]


@functools.cache
def _lib() -> ctypes.CDLL:
    from cst_captioning_tpu_torch.ops import build

    lib = build.load("additive_attention")
    lib.additive_attention.argtypes = [ctypes.POINTER(_AttentionArgs),
                                       ctypes.c_void_p]
    lib.additive_attention.restype = ctypes.c_int
    lib.additive_attention_error_string.argtypes = [ctypes.c_int]
    lib.additive_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, v, memory, memory_proj, mask):
    dev = memory.device
    B, M, E = memory.shape
    A = q.shape[-1]
    types = (torch.float32, torch.bfloat16)
    _expect(q, "q", dev, types, (B, A))
    for name, t, shape in (("v", v, (A,)), ("memory", memory, (B, M, E)),
                           ("memory_proj", memory_proj, (B, M, A))):
        _expect(t, name, dev, (q.dtype,), shape)
    _expect(mask, "mask", dev, (torch.float32,), (B, M))
    out = torch.empty((B, E), dtype=memory.dtype, device=dev)
    args = _AttentionArgs(
        q=q.data_ptr(), v=v.data_ptr(), mem=memory.data_ptr(),
        proj=memory_proj.data_ptr(), mask=mask.data_ptr(),
        out=out.data_ptr(), bf16=int(q.dtype == torch.bfloat16),
        B=B, M=M, A=A, E=E)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.additive_attention(ctypes.byref(args),
                                    ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.additive_attention_error_string(rc).decode()
        raise RuntimeError(
            f"additive_attention launch failed: {msg} (cudaError {rc})")
    fused_additive_attention.launches += 1
    return out


# ---- the wrapper -------------------------------------------------------------


class _FusedAdditiveAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, v, memory, memory_proj, mask):
        ctx.save_for_backward(q, v, memory, memory_proj, mask)
        if _device_of(memory).type == "cpu":
            return additive_attention_plain(q, v, memory, memory_proj, mask)
        return _launch(q, v, memory, memory_proj, mask)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(need)
                   for x, need in zip(saved[:4], ctx.needs_input_grad[:4])]
            out = additive_attention_plain(*ins, saved[4])
            wanted = [x for x in ins if x.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if x.requires_grad else None for x in ins),
                None)


def fused_additive_attention(q, v, memory, memory_proj, mask):
    """Masked additive-attention context -> [B, E] (module docstring)."""
    B, M = mask.shape
    if memory.ndim != 3 or memory.shape[:2] != (B, M) \
            or memory_proj.shape[:2] != (B, M) or q.shape != (B, v.shape[0]) \
            or memory_proj.shape[2] != v.shape[0]:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, v {tuple(v.shape)}, memory "
            f"{tuple(memory.shape)}, memory_proj {tuple(memory_proj.shape)}, "
            f"mask {tuple(mask.shape)} do not match [B, A], [A], [B, M, E], "
            "[B, M, A], [B, M]")
    return _FusedAdditiveAttention.apply(q, v, memory, memory_proj, mask)


fused_additive_attention.launches = 0
