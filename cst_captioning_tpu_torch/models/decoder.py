"""LSTM decoder cell with input-feed attention context.

One step: embed the previous token, attend over the encoder memory with the
previous top-layer hidden state, feed ``[word_emb, context]`` through the
LSTM stack, project to vocab logits. Dropout (flax ``nn.Dropout``) is
applied where the JAX cell applies it, after the ``[emb, ctx]`` concat,
between LSTM layers and before the output projection, and only in training
(a generator passed, the module in training mode); decode is
deterministic. ``ops/decode_step.py`` runs the same math for one step and
``ops/decode_stride.py`` for S steps, each in one kernel launch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cst_captioning_tpu_torch.config import ModelConfig
from cst_captioning_tpu_torch.device import torch_dtype
from cst_captioning_tpu_torch.models.attention import AdditiveAttention
from cst_captioning_tpu_torch.models.layers import Dense

# carry: tuple over layers of LSTM (c, h) pairs
Carry = tuple[tuple[torch.Tensor, torch.Tensor], ...]

# the order flax's OptimizedLSTMCell splits its gate matmul in; the rows of
# LSTMCell.weight_i / weight_h / bias are stacked in this order
LSTM_GATE_ORDER = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: ``gates = (h W_h + b) + x W_i`` split
    i|f|g|o; the input matmul has no bias."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight_i = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.weight_h = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))
        nn.init.uniform_(self.weight_i, -1 / math.sqrt(in_features),
                         1 / math.sqrt(in_features))
        nn.init.uniform_(self.weight_h, -1 / math.sqrt(hidden),
                         1 / math.sqrt(hidden))
        self.to(param_dtype)  # drawn in float32, stored in param_dtype

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        d = self.dtype
        gates = (F.linear(h.to(d), self.weight_h.to(d), self.bias.to(d))
                 + F.linear(x.to(d), self.weight_i.to(d)))
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_c, new_h


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` (the mask
    drawn from ``generator``) and scale the kept values by
    ``1 / (1 - rate)``."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class DecoderCell(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype = torch_dtype(cfg.dtype)
        pdtype = torch_dtype(cfg.param_dtype)
        E, H = cfg.d_embed, cfg.d_hidden
        self.word_embed = nn.Embedding(cfg.vocab_size, E).to(pdtype)
        self.attention = AdditiveAttention(E, H, cfg.d_att, dtype=dtype,
                                           impl=cfg.attention_impl,
                                           param_dtype=pdtype)
        self.lstm = nn.ModuleList([
            LSTMCell(2 * E if i == 0 else H, H, dtype=dtype,
                     param_dtype=pdtype)
            for i in range(cfg.num_layers)
        ])
        self.out_proj = Dense(H, cfg.vocab_size, dtype=dtype,
                              param_dtype=pdtype)

    def project_memory(self, memory: torch.Tensor) -> torch.Tensor:
        return self.attention.project_memory(memory)

    def forward(self, carry: Carry, token: torch.Tensor, memory: torch.Tensor,
                memory_proj: torch.Tensor, memory_mask: torch.Tensor,
                generator: torch.Generator | None = None):
        """One decode step -> (new carry, logits [B, V] float32). Dropout
        runs when ``generator`` is given and the module is in training
        mode."""
        train = generator is not None and self.training

        def drop(x):
            return dropout(x, self.cfg.dropout, generator) if train else x

        h_top = carry[-1][1]
        ctx = self.attention(h_top, memory, memory_proj, memory_mask)
        emb = self.word_embed.weight.to(self.dtype)[token]
        x = drop(torch.cat([emb, ctx], dim=-1))
        new_carry = []
        for i, cell in enumerate(self.lstm):
            c_i, h_i = cell(carry[i], x)
            new_carry.append((c_i, h_i))
            x = h_i if i + 1 == len(self.lstm) else drop(h_i)
        return tuple(new_carry), self.out_proj(drop(x)).float()
