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

from cst_captioning_tpu_torch.ops.decode_stride import _device_of

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

# the kernel's grid (kColVecs and kMaxCluster in the .cu)
COL_VECS = 16        # 16-byte column vectors of one pass of a block
MAX_CLUSTER = 8      # blocks a row at most: the portable cluster size
BLOCKS_PER_SM = 2    # the grid's target cover of the SMs


def attention_split(B: int, E: int, itemsize: int, sms: int,
                    n_e: int = 0) -> tuple[int, int]:
    """The kernel's grid: (nE, passes). Each row is a cluster of nE blocks
    (1, 2, 4 or 8), each block writing ``passes`` (1 or 2) passes of
    COL_VECS 16-byte column vectors; a row's blocks cover nE x passes
    passes a column group, in as many groups as E needs, and score the
    row again for each group. nE is the least power of two that gives
    about BLOCKS_PER_SM blocks an SM over all rows and covers E in one
    group, never more than MAX_CLUSTER or the passes in E; ``n_e`` > 0
    asks for the power of two at or below it instead (the tests' hook)."""
    total = max(1, -(-E // (COL_VECS * (16 // itemsize))))
    if n_e <= 0:
        fill = -(-BLOCKS_PER_SM * sms // max(B, 1))
        n_e = max(1 << (fill.bit_length() - 1),
                  1 << (-(-total // 2) - 1).bit_length())
    n_e = 1 << (max(1, min(n_e, total, MAX_CLUSTER)).bit_length() - 1)
    return n_e, 1 if n_e >= total else 2


class _AttentionArgs(ctypes.Structure):
    """Mirror of ``struct AttentionArgs`` in csrc/additive_attention.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "v", "mem", "proj", "mask", "out")] + [
        (n, ctypes.c_int) for n in ("bf16", "B", "M", "A", "E", "nE",
                                    "passes")]


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


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, v, memory, memory_proj, mask, n_e: int = 0):
    """Launch the kernel on shape-checked CUDA tensors -> ctx [B, E];
    ``n_e`` > 0 asks for that many column blocks a row."""
    dev = memory.device
    dt = memory.dtype
    ins = (q, v, memory, memory_proj, mask)
    for name, t in zip(("q", "v", "memory", "memory_proj", "mask"), ins):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dt not in (torch.float32, torch.bfloat16) or q.dtype != dt \
            or v.dtype != dt or memory_proj.dtype != dt \
            or mask.dtype != torch.float32:
        raise ValueError(
            f"dtypes q {q.dtype}, v {v.dtype}, memory {dt}, memory_proj "
            f"{memory_proj.dtype}, mask {mask.dtype}: expected one of "
            "float32 and bfloat16 for the first four, float32 for the mask")
    B, M, E = memory.shape
    n_e, passes = attention_split(B, E, memory.element_size(),
                                  _sm_count(dev.index), n_e)
    out = torch.empty((B, E), dtype=dt, device=dev)
    args = _AttentionArgs(
        q.data_ptr(), v.data_ptr(), memory.data_ptr(),
        memory_proj.data_ptr(), mask.data_ptr(), out.data_ptr(),
        int(dt == torch.bfloat16), B, M, q.shape[1], E, n_e, passes)
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.additive_attention(ctypes.byref(args), stream)
    else:
        with torch.cuda.device(dev):
            rc = lib.additive_attention(ctypes.byref(args), stream)
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
    if memory.ndim != 3 or memory.shape[:2] != (B, M) or v.ndim != 1 \
            or memory_proj.shape[:2] != (B, M) or q.shape != (B, v.shape[0]) \
            or memory_proj.shape[2] != v.shape[0]:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, v {tuple(v.shape)}, memory "
            f"{tuple(memory.shape)}, memory_proj {tuple(memory_proj.shape)}, "
            f"mask {tuple(mask.shape)} do not match [B, A], [A], [B, M, E], "
            "[B, M, A], [B, M]")
    return _FusedAdditiveAttention.apply(q, v, memory, memory_proj, mask)


fused_additive_attention.launches = 0
