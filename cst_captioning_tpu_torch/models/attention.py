"""Additive (Bahdanau) attention over a memory bank.

Scores are ``v . tanh(W_f f + W_h h)``; the memory projection ``W_f f`` is
computed once per clip (:meth:`AdditiveAttention.project_memory`), so a
step costs one small matmul and a masked softmax. ``impl="pallas"`` routes
the context through ``ops.attention.fused_additive_attention`` (the
additive-attention kernel on the GPU), with the ``score`` vector as ``v``;
``"xla"`` keeps the plain composite below.

Sequence parallelism (``seq``, the row of a ``('data', 'seq')`` grid, set
by ``parallel.seq_parallel.sp_model`` on a frame-sharded bank): the
softmax becomes a two-pass reduction over the row, the max of the local
score maxima (a constant shift, outside autograd), then one all-reduce of
the numerator ``[B, E]`` and the denominator, in float32. The query enters
the local scores through ``seq_enter``, so its cotangent is summed over
the row. Attention is permutation-invariant over the slots, so the
sharded context equals the one-device softmax up to summation order. The
kernel never runs there: its softmax is one device's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cst_captioning_tpu_torch.models.layers import Dense
from cst_captioning_tpu_torch.ops import attention as attention_ops


class AdditiveAttention(nn.Module):
    def __init__(self, d_memory: int, d_query: int, d_att: int,
                 dtype: torch.dtype = torch.float32, impl: str = "xla",
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.impl = impl
        # the row the bank's frames are sharded over (None: all here)
        self.seq = None
        self.mem_proj = Dense(d_memory, d_att, bias=False, dtype=dtype,
                              param_dtype=param_dtype)
        self.query_proj = Dense(d_query, d_att, dtype=dtype,
                                param_dtype=param_dtype)
        # v: the flax ``score`` Dense kernel [A, 1] without its unit axis,
        # drawn in float32 and stored in param_dtype; every use reads it in
        # the compute dtype (the kernel takes v in the bank's dtype)
        score = torch.empty(d_att)
        bound = 1.0 / math.sqrt(d_att)
        nn.init.uniform_(score, -bound, bound)
        self.score = nn.Parameter(score.to(param_dtype))

    def project_memory(self, memory: torch.Tensor) -> torch.Tensor:
        """[B, M, E] -> [B, M, d_att]."""
        return self.mem_proj(memory)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                memory_proj: torch.Tensor,
                memory_mask: torch.Tensor) -> torch.Tensor:
        """query [B, H] -> context [B, E]: mask-weighted sum of memory slots."""
        d = self.dtype
        q = self.query_proj(query)
        if self.seq is not None:
            return self._sharded_attend(q, memory, memory_proj, memory_mask)
        if self.impl == "pallas":
            return attention_ops.fused_additive_attention(
                q, self.score.to(d), memory, memory_proj, memory_mask)
        t = torch.tanh(memory_proj.to(d) + q.unsqueeze(1))
        scores = t @ self.score.to(d)                          # [B, M]
        # -1e9, not -inf: a row with no valid slot gets a finite uniform
        # softmax over zeroed memory instead of NaNs
        scores = torch.where(memory_mask > 0, scores,
                             torch.full_like(scores, -1.0e9))
        weights = torch.softmax(scores.float(), dim=-1).to(memory.dtype)
        return torch.einsum("bm,bme->be", weights, memory)

    def _sharded_attend(self, q, memory, memory_proj, memory_mask):
        """The distributed masked softmax over the row's frame shards."""
        from cst_captioning_tpu_torch.parallel import seq_parallel as sp

        d = self.dtype
        q = sp.seq_enter(q, self.seq)
        t = torch.tanh(memory_proj.to(d) + q.unsqueeze(1))
        scores = t @ self.score.to(d)                          # [B, M_local]
        scores = torch.where(memory_mask > 0, scores,
                             torch.full_like(scores, -1.0e9)).float()
        m = sp.seq_max(scores.max(dim=-1).values, self.seq)    # global max
        w = torch.exp(scores - m[:, None])
        num = torch.einsum("bm,bme->be", w.to(memory.dtype), memory)
        # numerator and denominator in one all-reduce
        both = sp.seq_sum(torch.cat([num.float(), w.sum(-1, keepdim=True)],
                                    dim=-1), self.seq)
        return (both[:, :-1] / both[:, -1:]).to(memory.dtype)
