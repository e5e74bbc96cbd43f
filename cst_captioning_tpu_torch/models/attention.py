"""Additive (Bahdanau) attention over a memory bank.

Scores are ``v . tanh(W_f f + W_h h)``; the memory projection ``W_f f`` is
computed once per clip (:meth:`AdditiveAttention.project_memory`), so a
step costs one small matmul and a masked softmax. ``impl="pallas"`` routes
the context through ``ops.attention.fused_additive_attention`` (the
additive-attention kernel on the GPU), with the ``score`` vector as ``v``;
``"xla"`` keeps the plain composite below. The sequence-parallel path of
the JAX package comes with a later slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cst_captioning_tpu_torch.models.layers import Dense
from cst_captioning_tpu_torch.ops import attention as attention_ops


class AdditiveAttention(nn.Module):
    def __init__(self, d_memory: int, d_query: int, d_att: int,
                 dtype: torch.dtype = torch.float32, impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.impl = impl
        self.mem_proj = Dense(d_memory, d_att, bias=False, dtype=dtype)
        self.query_proj = Dense(d_query, d_att, dtype=dtype)
        # v: the flax ``score`` Dense kernel [A, 1] without its unit axis
        self.score = nn.Parameter(torch.empty(d_att))
        bound = 1.0 / math.sqrt(d_att)
        nn.init.uniform_(self.score, -bound, bound)

    def project_memory(self, memory: torch.Tensor) -> torch.Tensor:
        """[B, M, E] -> [B, M, d_att]."""
        return self.mem_proj(memory)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                memory_proj: torch.Tensor,
                memory_mask: torch.Tensor) -> torch.Tensor:
        """query [B, H] -> context [B, E]: mask-weighted sum of memory slots."""
        d = self.dtype
        q = self.query_proj(query)
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
