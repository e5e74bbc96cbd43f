"""One decode step over a lane-batched state: the wrapper, its plain
PyTorch version and the CUDA kernel's binding.

:func:`fused_decode_step` keeps the argument contract of the JAX package's
TPU kernel of the same name (``cst_captioning_tpu/ops/decode_pallas.py``),
with the decoder cell module in place of its flax parameter tree:

    carry   L x (c, h) [G, B, H]       token [G, B] int
    memory / memory_proj / memory_mask  [B, M, E] / [B, M, A] / [B, M],
            shared by the G lanes
    -> (new carry in the carry's dtype, logits [G, B, V] float32)

All arithmetic is float32 whatever the model dtype; PAD and BOS are not
masked and no token is selected (the decode loop does both). The embedding
rows are gathered outside the kernel, as in the JAX op, in the pack's
dtype. ``weights`` takes the cell's packed weights (``stride_weights``, in
the parameters' dtype, float32 or bfloat16) so a decode loop packs them
once, not once per step; the kernel and the plain version widen each
weight where they read it. :func:`fused_decode_step_` is the same
step on a carry kept as one float32 tensor across a decode loop and
updated in place.

On CUDA tensors the wrappers launch the hand-written kernel
``csrc/decode_step.cu`` (its launches in ``csrc/step.cuh``, built by
``ops/build.py``) and count the launch in ``fused_decode_step.launches``
(those on a bfloat16 pack in ``launches_bf16`` too);
on CPU tensors they run :func:`decode_step_plain`. The wrapper allocates
the kernel's scratch (:func:`step_workspace`, which the kernel checks).
Decode never takes gradients, so there is no autograd rule. Nothing falls
back: a CUDA call that cannot launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cst_captioning_tpu_torch.ops.decode_stride import (
    NEG,
    SPLIT_K,
    StrideWeights,
    _cdiv,
    _device_of,
    _expect,
    stride_weights,
)


def decode_step_plain(w: StrideWeights, carry, emb, memory, memory_proj,
                      memory_mask):
    """The JAX op's float32 reference composite (``_reference``) with the
    embedding rows ``emb`` [G, B, E] given; each weight is widened to
    float32 where it is used (the identity on a float32 pack)."""
    h_top = carry[-1][1].float()
    q = h_top @ w.wq.float() + w.bq.float()                       # [G, B, A]
    t = torch.tanh(memory_proj.float()[None] + q[:, :, None, :])
    s = t @ w.v.float()                                           # [G, B, M]
    s = torch.where(memory_mask[None] > 0, s, torch.full_like(s, NEG))
    att = torch.softmax(s, dim=-1)
    ctx = torch.einsum("gbm,bme->gbe", att, memory.float())
    x = torch.cat([emb.float(), ctx], dim=-1)
    H4 = w.bg.shape[1]
    new_carry = []
    off = 0
    for layer, (c, h) in enumerate(carry):
        n_in = x.shape[-1]
        wx = w.wx[off:off + n_in * H4].view(n_in, H4).float()
        off += n_in * H4
        gates = x @ wx + h.float() @ w.wh[layer].float() + w.bg[layer].float()
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        new_carry.append((c_new.to(c.dtype), h_new.to(h.dtype)))
        x = h_new
    return tuple(new_carry), x @ w.wo.float() + w.bo.float()


# ---- the kernel's binding ----------------------------------------------------


def stack_carry(carry) -> torch.Tensor:
    """L x (c, h) [G, B, H] -> the kernel's float32 carry [2, L, G, B, H]:
    every layer's c, then every layer's h."""
    L = len(carry)
    flat = [c for c, _ in carry] + [h for _, h in carry]
    return torch.stack(flat).float().view((2, L) + tuple(flat[0].shape))


def unstack_carry(state: torch.Tensor, dtype: torch.dtype):
    """[2, L, G, B, H] -> L x (c, h) [G, B, H] in ``dtype``."""
    return tuple((state[0, i].to(dtype), state[1, i].to(dtype))
                 for i in range(state.shape[1]))


def step_workspace(G: int, B: int, E: int, Em: int, A: int,
                   H: int) -> dict[str, int]:
    """The kernel's scratch regions in floats, in its order (``carve`` in
    csrc/step.cuh, which checks the total), each rounded up to 4 floats:
    over the R = G * B lane rows, q's and the widest gate GEMM's split-K
    partials (256-deep k slices), the layer-0 input (emb | ctx) and the
    layer's new h before rounding."""
    R = G * B
    sizes = {"q": _cdiv(H, SPLIT_K) * R * A,
             "gates": _cdiv(max(E + Em, H) + H, SPLIT_K) * R * 4 * H,
             "x": R * (E + Em), "h": R * H}
    return {k: _cdiv(n, 4) * 4 for k, n in sizes.items()}


class _StepArgs(ctypes.Structure):
    """Mirror of ``struct StepArgs`` in csrc/step.cuh."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "mem", "proj", "mask", "wq", "bq", "v", "wx", "wh", "bg", "wo", "bo",
        "emb", "c", "h", "logits", "scratch",
    )] + [("scratch_floats", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in (
            "bank_bf16", "carry_bf16", "weights_bf16", "G", "B", "M", "V",
            "E", "Em", "A", "H", "L")]


@functools.cache
def _lib() -> ctypes.CDLL:
    from cst_captioning_tpu_torch.ops import build

    lib = build.load("decode_step")
    lib.decode_step.argtypes = [ctypes.POINTER(_StepArgs), ctypes.c_void_p]
    lib.decode_step.restype = ctypes.c_int
    lib.decode_step_scratch_floats.argtypes = [ctypes.POINTER(_StepArgs)]
    lib.decode_step_scratch_floats.restype = ctypes.c_longlong
    lib.decode_step_error_string.argtypes = [ctypes.c_int]
    lib.decode_step_error_string.restype = ctypes.c_char_p
    return lib


def step_args(w: StrideWeights, state, emb, mem, proj, mask,
              carry_dtype: torch.dtype, logits: torch.Tensor | None):
    """Check a step's tensors -> (``_StepArgs``, scratch).

    ``state`` [2, L, G, B, H] steps in place; ``logits`` [G, B, V] receives
    the logits (None: the beam step, which reduces them in the kernel).
    The weights and ``emb`` are in the pack's dtype (``weights_bf16``).
    The caller keeps the scratch alive until the launch is queued."""
    dev = mem.device
    G, B, E = emb.shape
    M, Em = mem.shape[1], mem.shape[2]
    A = proj.shape[-1]
    L, H = state.shape[1], state.shape[-1]
    V = w.bo.shape[0]
    bank_types = (torch.float32, torch.bfloat16)
    if carry_dtype not in bank_types:
        raise ValueError(f"carry dtype {carry_dtype}, expected one of "
                         f"{bank_types}")
    _expect(mem, "memory", dev, bank_types, (B, M, Em))
    _expect(proj, "memory_proj", dev, (mem.dtype,), (B, M, A))
    _expect(mask, "memory_mask", dev, (torch.float32,), (B, M))
    _expect(emb, "emb", dev, (w.dtype,), (G, B, E))
    _expect(state, "carry", dev, (torch.float32,), (2, L, G, B, H))
    if (dev, E, Em, A, H, L, w.dtype) not in w.checked:
        shapes = {"wq": (H, A), "bq": (A,), "v": (A,), "wh": (L, H, 4 * H),
                  "bg": (L, 4 * H), "wo": (H, V), "bo": (V,),
                  "wx": ((E + Em) * 4 * H + (L - 1) * H * 4 * H,)}
        for name, shape in shapes.items():
            _expect(getattr(w, name), name, dev, (w.dtype,), shape)
        w.checked.add((dev, E, Em, A, H, L, w.dtype))
    n = sum(step_workspace(G, B, E, Em, A, H).values())
    scratch = torch.empty((n,), dtype=torch.float32, device=dev)
    args = _StepArgs(
        mem=mem.data_ptr(), proj=proj.data_ptr(), mask=mask.data_ptr(),
        wq=w.wq.data_ptr(), bq=w.bq.data_ptr(), v=w.v.data_ptr(),
        wx=w.wx.data_ptr(), wh=w.wh.data_ptr(), bg=w.bg.data_ptr(),
        wo=w.wo.data_ptr(), bo=w.bo.data_ptr(), emb=emb.data_ptr(),
        c=state[0].data_ptr(), h=state[1].data_ptr(),
        logits=None if logits is None else logits.data_ptr(),
        scratch=scratch.data_ptr(), scratch_floats=n,
        bank_bf16=int(mem.dtype == torch.bfloat16),
        carry_bf16=int(carry_dtype == torch.bfloat16),
        weights_bf16=int(w.dtype == torch.bfloat16), G=G, B=B, M=M, V=V,
        E=E, Em=Em, A=A, H=H, L=L,
    )
    return args, scratch


def _launch(w: StrideWeights, state, emb, mem, proj, mask,
            carry_dtype: torch.dtype) -> torch.Tensor:
    """Step ``state`` [2, L, G, B, H] in place -> logits [G, B, V]."""
    G, B = emb.shape[:2]
    logits = torch.empty((G, B, w.bo.shape[0]), dtype=torch.float32,
                         device=mem.device)
    args, _scratch = step_args(w, state, emb, mem, proj, mask, carry_dtype,
                               logits)
    lib = _lib()
    # the launch is asynchronous; the scratch may be freed on return
    # because the caching allocator reuses its memory only for work queued
    # later on this same stream
    stream = torch.cuda.current_stream(mem.device).cuda_stream
    with torch.cuda.device(mem.device):
        rc = lib.decode_step(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.decode_step_error_string(rc).decode()
        raise RuntimeError(f"decode_step launch failed: {msg} (cudaError {rc})")
    fused_decode_step.launches += 1
    fused_decode_step.launches_bf16 += int(w.dtype == torch.bfloat16)
    return logits


# ---- the wrappers ------------------------------------------------------------


def prepare(cell, n_layers: int, token, memory, memory_mask, num_layers,
            emb, weights):
    """Check the arguments -> (packed weights, embedding rows [G, B, E])."""
    w = weights if weights is not None else stride_weights(cell)
    if num_layers is not None and num_layers != w.num_layers:
        raise ValueError(
            f"num_layers {num_layers} does not match the cell's "
            f"{w.num_layers} layers")
    if n_layers != w.num_layers:
        raise ValueError(
            f"carry has {n_layers} layers, the cell {w.num_layers}")
    G, B = token.shape
    if memory.ndim != 3 or memory.shape[0] != B \
            or memory_mask.shape != memory.shape[:2]:
        raise ValueError(
            f"memory {tuple(memory.shape)} / mask {tuple(memory_mask.shape)} "
            f"do not match [B={B}, M]")
    if emb is None:
        emb = w.embt[token.long()]
    return w, emb


def fused_decode_step(cell, carry, token, memory, memory_proj, memory_mask,
                      num_layers: int | None = None, emb=None,
                      weights: StrideWeights | None = None):
    """One decode step -> (new carry, logits [G, B, V]) (module docstring)."""
    w, emb = prepare(cell, len(carry), token, memory, memory_mask,
                      num_layers, emb, weights)
    if _device_of(memory).type == "cpu":
        return decode_step_plain(w, carry, emb, memory, memory_proj,
                                 memory_mask)
    dtype = carry[0][0].dtype
    state = stack_carry(carry)
    logits = _launch(w, state, emb, memory, memory_proj, memory_mask, dtype)
    return unstack_carry(state, dtype), logits


def fused_decode_step_(cell, state, token, memory, memory_proj, memory_mask,
                       carry_dtype: torch.dtype, num_layers: int | None = None,
                       emb=None, weights: StrideWeights | None = None):
    """:func:`fused_decode_step` on a decode loop's carry kept as one
    float32 tensor [2, L, G, B, H] (:func:`stack_carry`): ``state`` steps in
    place to the new carry, its values rounded to ``carry_dtype`` as the
    functional wrapper's are -> logits [G, B, V]. The loop then stacks,
    casts and copies nothing per step."""
    w, emb = prepare(cell, state.shape[1], token, memory, memory_mask,
                      num_layers, emb, weights)
    if _device_of(memory).type == "cpu":
        carry, logits = decode_step_plain(
            w, unstack_carry(state, carry_dtype), emb, memory, memory_proj,
            memory_mask)
        state.copy_(stack_carry(carry))
        return logits
    return _launch(w, state, emb, memory, memory_proj, memory_mask,
                   carry_dtype)


fused_decode_step.launches = fused_decode_step.launches_bf16 = 0
