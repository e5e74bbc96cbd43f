"""Linear layer with a compute dtype, the counterpart of flax ``nn.Dense``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` stored in ``param_dtype`` that computes in ``dtype``:
    input, weight and bias are cast to the compute dtype first — flax's
    ``Dense(dtype=..., param_dtype=...)``. The parameters are drawn in
    float32 and rounded to ``param_dtype``. The weight is ``[out, in]``,
    the transpose of flax's kernel."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.to(param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)
