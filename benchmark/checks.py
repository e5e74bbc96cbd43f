"""``correct``: what the timed path produced, judged by the plain
reference (``reference/``), each number beside its limit.

Each traffic kind's ``judge`` (``kinds/<kind>.py``) follows the first
three steps from the same weights and the same batches, worked out again
from the pool's files, and reads its own numbers; the training kinds
share ``training_gaps``:

- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step, over ``1 - b1``), leaf by leaf
  ``|norm_port - norm_ref|`` over the larger of the leaf's and the median
  leaf's reference norm, the worst leaf;
- ``change_gap``: the parameters' change over the three steps, the same
  way; leaves whose reference gradient is under a thousandth of the
  median leaf's are left out of both.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.batches import Pool

LEAF_FLOOR = 1e-3           # leaves under this share of the median grad


def to_dev(x: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}


def pool_of(cell, root: Path) -> Pool:
    """The cell's split of the pool at ``root``, as the reference reads
    it."""
    return Pool(root, cell.traffic["split"], int(cell.model["max_frames"]))


def leaves(w0: dict) -> dict:
    """The weights as float32 leaves that take a gradient."""
    return {k: v.detach().float().clone().requires_grad_(True)
            for k, v in w0.items()}


class Adam:
    """optax's ``clip_by_global_norm -> adam -> scale(-lr)``, float32."""

    def __init__(self, params: dict, lr: float, clip: float):
        self.lr, self.clip, self.n = lr, clip, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def clipped(self, grads: dict) -> dict:
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if self.clip > 0 and float(norm) >= self.clip:
            return {k: g / norm * self.clip for k, g in grads.items()}
        return grads

    def step(self, params: dict, grads: dict) -> dict:
        self.n += 1
        c1, c2 = 1 - 0.9 ** self.n, 1 - 0.999 ** self.n
        out = {}
        for k, g in grads.items():
            self.mu[k] = 0.1 * g + 0.9 * self.mu[k]
            self.nu[k] = 0.001 * g * g + 0.999 * self.nu[k]
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + 1e-8)
            out[k] = (params[k] - self.lr * upd).detach().requires_grad_(True)
        return out


def leaf_gap(port: dict, ref: dict, keep) -> float:
    """The worst leaf's ``|norm_port - norm_ref|`` over the larger of the
    leaf's and the median leaf's reference norm."""
    names = [k for k in ref if keep(k)]
    rn = {k: float(ref[k].norm()) for k in names}
    med = float(np.median(list(rn.values())))
    return max(abs(float(port[k].norm()) - rn[k]) / max(rn[k], med, 1e-30)
               for k in names)


def kept(grads: dict):
    """The rule on the reference's first gradient: a leaf counts where
    its norm is at least ``LEAF_FLOOR`` of the median leaf's."""
    norms = {k: float(g.norm()) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    return lambda k: norms[k] >= LEAF_FLOOR * med


def training_gaps(cap: dict, g1: dict, params: dict, dev) -> dict:
    """``grad_gap`` and ``change_gap`` of a capture against the
    reference's first clipped gradient ``g1`` and its parameters after
    the capture's steps."""
    keep = kept(g1)
    g1_port = {k: v / 0.1 for k, v in cap["mu1"].items()}
    d_port = {k: cap["p3"][k].to(dev) - cap["w0"][k] for k in params}
    d_ref = {k: params[k].detach() - cap["w0"][k] for k in params}
    return {"grad_gap": leaf_gap(g1_port, g1, keep),
            "change_gap": leaf_gap(d_port, d_ref, keep)}


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every reading within its limit, {name: {"value", "limit"}})."""
    out = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
