"""One beam-search step with its top-W candidate selection: the wrapper, its
plain PyTorch version and the CUDA kernel's binding.

:func:`fused_beam_step` keeps the argument contract of the JAX package's
TPU kernel of the same name (``cst_captioning_tpu/ops/decode_pallas.py``),
with the decoder cell module in place of its flax parameter tree:

    carry     L x (c, h) [W, B, H]     token [W, B] int (each beam's last)
    finished  [W, B] bool              scores [W, B] float32
    memory / memory_proj / memory_mask  [B, M, E] / [B, M, A] / [B, M]
    t         the step index (masks EOS while t < min_len)
    -> (new carry, top_scores [B, W] float32, top_flat [B, W] int32)

The step is :func:`ops.decode_step.decode_step_plain`'s; then PAD and BOS
are masked, EOS too while ``t < min_len``, live lanes score ``score +
(logit - logsumexp)`` and finished lanes continue with PAD alone. The
result is the per-row top W over the flat ids ``lane * V + token``, value
descending, ties toward the lower flat id (``lax.top_k``'s order). The
caller derives parent and token from ``top_flat`` and reorders the
hypotheses between steps. :func:`fused_beam_step_` is the same step on a
carry kept as one float32 tensor [2, L, W, B, H] and updated in place.

On CUDA tensors the wrappers launch the hand-written kernel
``csrc/beam_step.cu`` (the step's launches from ``csrc/step.cuh``, then a
merge; built by ``ops/build.py``) and count the launch in
``fused_beam_step.launches`` (those on a bfloat16 pack in
``launches_bf16`` too); on CPU tensors they run
:func:`beam_step_plain`. The kernel writes no logits: its logits GEMM
leaves per-tile selection partials in a workspace
(:func:`beam_workspace`) that a merge launch reduces. Nothing falls back:
a CUDA call that cannot launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_tpu_torch.ops.decode_step import (
    _StepArgs,
    decode_step_plain,
    prepare,
    stack_carry,
    step_args,
    unstack_carry,
)
from cst_captioning_tpu_torch.ops.decode_stride import (
    NEG,
    TILE_N,
    StrideWeights,
    _cdiv,
    _device_of,
    _expect,
)

MAX_BEAM = 16   # the kernel's widest beam (kMaxBeam in csrc/beam_step.cu)


def top_w(total: torch.Tensor, W: int):
    """[B, N] -> the first W of each row by value descending, ties toward
    the lower index (a stable sort): (values [B, W], indices [B, W])."""
    vals, idx = torch.sort(total, dim=1, descending=True, stable=True)
    return vals[:, :W], idx[:, :W]


def beam_topk_plain(logits, finished, scores, *, t: int, min_len: int,
                    width: int | None = None):
    """The selection on a step's logits [W, B, V] (the JAX op's
    ``_reference_beam_topk`` after its step) -> (top_scores, top_flat),
    the first ``width`` candidates (default W; the kernel checks ask for
    one more to see how near the next one is)."""
    W, B, V = logits.shape
    logits = logits.clone()
    logits[..., PAD_ID] = NEG
    logits[..., BOS_ID] = NEG
    if min_len > 0 and t < min_len:
        logits[..., EOS_ID] = NEG
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    logp = logp.transpose(0, 1)                                   # [B, W, V]
    pad_row = torch.full((V,), NEG, device=logits.device)
    pad_row[PAD_ID] = 0.0
    cont = torch.where(finished.T.bool()[:, :, None], pad_row, logp)
    total = scores.T.float()[:, :, None] + cont
    vals, flat = top_w(total.reshape(B, W * V), width or W)
    return vals, flat.to(torch.int32)


def beam_step_plain(w: StrideWeights, carry, emb, finished, scores, memory,
                    memory_proj, memory_mask, *, t: int, min_len: int):
    """The beam step in plain PyTorch, on any device, with the embedding
    rows ``emb`` [W, B, E] given -> (new carry, top_scores, top_flat)."""
    new_carry, logits = decode_step_plain(w, carry, emb, memory, memory_proj,
                                          memory_mask)
    return (new_carry,) + beam_topk_plain(logits, finished, scores, t=t,
                                          min_len=min_len)


# ---- the kernel's binding ----------------------------------------------------


def beam_workspace(W: int, B: int, V: int) -> int:
    """Floats of the beam kernel's selection partials (``part_floats`` in
    csrc/beam_step.cu, which checks them): for each of the W * B lane rows
    and each 64-column logits tile, the masked logits' max and sum of exps,
    then the tile's top W values and their columns."""
    return W * B * _cdiv(V, TILE_N) * (2 + 2 * W)


class _BeamArgs(ctypes.Structure):
    """Mirror of ``struct BeamArgs`` in csrc/beam_step.cu."""

    _fields_ = [("step", _StepArgs)] + [(n, ctypes.c_void_p) for n in (
        "finished", "scores", "top_scores", "top_flat", "part",
    )] + [("part_floats", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("t", "min_len")]


@functools.cache
def _lib() -> ctypes.CDLL:
    from cst_captioning_tpu_torch.ops import build

    lib = build.load("beam_step")
    lib.beam_step.argtypes = [ctypes.POINTER(_BeamArgs), ctypes.c_void_p]
    lib.beam_step.restype = ctypes.c_int
    lib.beam_step_part_floats.argtypes = [ctypes.POINTER(_BeamArgs)]
    lib.beam_step_part_floats.restype = ctypes.c_longlong
    lib.beam_step_error_string.argtypes = [ctypes.c_int]
    lib.beam_step_error_string.restype = ctypes.c_char_p
    return lib


def _launch(w: StrideWeights, state, emb, finished, scores, mem, proj, mask,
            carry_dtype: torch.dtype, t: int, min_len: int, workspace=None):
    """Step ``state`` [2, L, W, B, H] in place -> (top_scores, top_flat)."""
    dev = mem.device
    W, B = finished.shape
    if W > MAX_BEAM:
        raise ValueError(f"beam width {W} is above the kernel's {MAX_BEAM}")
    step, _scratch = step_args(w, state, emb, mem, proj, mask, carry_dtype,
                               None)
    n_part = beam_workspace(W, B, w.bo.shape[0])
    if workspace is None:
        workspace = torch.empty((n_part,), dtype=torch.float32, device=dev)
    _expect(workspace, "workspace", dev, (torch.float32,))
    if workspace.numel() < n_part:
        raise ValueError(f"workspace holds {workspace.numel()} floats, the "
                         f"step needs {n_part} (beam_workspace)")
    fin = finished.to(torch.int32).contiguous()
    sc = scores.to(torch.float32).contiguous()
    _expect(fin, "finished", dev, (torch.int32,), (W, B))
    _expect(sc, "scores", dev, (torch.float32,), (W, B))
    top_scores = torch.empty((B, W), dtype=torch.float32, device=dev)
    top_flat = torch.empty((B, W), dtype=torch.int32, device=dev)
    args = _BeamArgs(step=step, finished=fin.data_ptr(),
                     scores=sc.data_ptr(), top_scores=top_scores.data_ptr(),
                     top_flat=top_flat.data_ptr(),
                     part=workspace.data_ptr(),
                     part_floats=workspace.numel(), t=int(t),
                     min_len=int(min_len))
    lib = _lib()
    # the launch is asynchronous; the temporaries may be freed on return
    # because the caching allocator reuses their memory only for work
    # queued later on this same stream
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.beam_step(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.beam_step_error_string(rc).decode()
        raise RuntimeError(f"beam_step launch failed: {msg} (cudaError {rc})")
    fused_beam_step.launches += 1
    fused_beam_step.launches_bf16 += int(w.dtype == torch.bfloat16)
    return top_scores, top_flat


# ---- the wrappers ------------------------------------------------------------


def _check(w: StrideWeights, token, finished, scores) -> None:
    W, B = token.shape
    V = w.bo.shape[0]
    if W > V:
        raise ValueError(
            f"fused_beam_step needs beam width <= vocab to fill every lane's "
            f"candidate list; got W={W} > V={V}")
    for name, x in (("finished", finished), ("scores", scores)):
        if tuple(x.shape) != (W, B):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"[W={W}, B={B}]")


def fused_beam_step(cell, carry, token, finished, scores, memory,
                    memory_proj, memory_mask, *, t: int, min_len: int = 0,
                    num_layers: int | None = None,
                    weights: StrideWeights | None = None):
    """One beam step -> (new carry, top_scores [B, W], top_flat [B, W])
    (module docstring)."""
    w, emb = prepare(cell, len(carry), token, memory, memory_mask,
                     num_layers, None, weights)
    _check(w, token, finished, scores)
    if _device_of(memory).type == "cpu":
        return beam_step_plain(w, carry, emb, finished, scores, memory,
                               memory_proj, memory_mask, t=t,
                               min_len=min_len)
    dtype = carry[0][0].dtype
    state = stack_carry(carry)
    top = _launch(w, state, emb, finished, scores, memory, memory_proj,
                  memory_mask, dtype, t, min_len)
    return (unstack_carry(state, dtype),) + top


def fused_beam_step_(cell, state, token, finished, scores, memory,
                     memory_proj, memory_mask, carry_dtype: torch.dtype, *,
                     t: int, min_len: int = 0, num_layers: int | None = None,
                     weights: StrideWeights | None = None, logits=None):
    """:func:`fused_beam_step` on a beam search's carry kept as one float32
    tensor [2, L, W, B, H]: ``state`` steps in place to the new carry,
    rounded to ``carry_dtype`` -> (top_scores, top_flat). ``logits``, a
    contiguous float32 buffer of at least :func:`beam_workspace` floats
    that the search allocates once, is the kernel's workspace on the GPU:
    it receives the selection partials of the step's logits, which never
    reach device memory themselves (allocated per call when None)."""
    w, emb = prepare(cell, state.shape[1], token, memory, memory_mask,
                     num_layers, None, weights)
    _check(w, token, finished, scores)
    if _device_of(memory).type == "cpu":
        carry, top_scores, top_flat = beam_step_plain(
            w, unstack_carry(state, carry_dtype), emb, finished, scores,
            memory, memory_proj, memory_mask, t=t, min_len=min_len)
        state.copy_(stack_carry(carry))
        return top_scores, top_flat
    return _launch(w, state, emb, finished, scores, memory, memory_proj,
                   memory_mask, carry_dtype, t, min_len, logits)


fused_beam_step.launches = fused_beam_step.launches_bf16 = 0
