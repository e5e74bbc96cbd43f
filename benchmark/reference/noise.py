"""The rollouts' Gumbel noise, worked out again: a frozen copy of the
counter hash the port's sampled decode draws with (``seed`` the batch's
rollout seed, then row, rollout, step and token), so the reference can
ask of each sampled token whether it was the argmax of its logits plus
its noise."""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel(seed: int, K: int, B: int, V: int, t: int, device) -> torch.Tensor:
    """Step ``t``'s noise [K, B, V] float32 of a batch of B rows."""
    dev = torch.device(device)
    rows = torch.arange(B, device=dev, dtype=torch.int64)
    seeds = _mix32((int(seed) & _M32) ^ _mix32(rows + 0x165667B1))
    x = _mix32((seeds & _M32) ^ 0x9E3779B9)[None, :, None]
    k = torch.arange(K, device=dev, dtype=torch.int64)[:, None, None]
    x = _mix32(x ^ _mix32(k + 0x632BE5AB))
    x = _mix32(x ^ _mix32(torch.full((1, B, 1), int(t), device=dev,
                                     dtype=torch.int64) + 0x85EBCA77))
    v = torch.arange(V, device=dev, dtype=torch.int64)[None, None, :]
    x = _mix32(x ^ _mix32(v + 0xC2B2AE3D))
    u = ((x >> 8).to(torch.float64) + 0.5) * np.float64(2.0 ** -24)
    return (-torch.log(-torch.log(u))).to(torch.float32)
