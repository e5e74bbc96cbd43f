"""The cells' weights: drawn on the device from the run's seed, in one
call, and cut into the named leaves.

The names and shapes are the caption model's (``encoder.embed.<mod>``,
``cell.word_embed``, ``cell.attention.*``, ``cell.lstm.<l>.*``,
``cell.out_proj``, ``init_c.<l>``, ``init_h.<l>``); both the port and
the reference take them by name. Each leaf is uniform in
``[-b, b]``: ``b = 1/sqrt(fan_in)`` for a matrix and its bias,
``sqrt(3)`` (unit variance) for the word embedding.
"""

from __future__ import annotations

import math

import torch


def leaf_specs(model: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, bound) of every leaf, in the port's parameter
    order."""
    E, H, A = model["d_embed"], model["d_hidden"], model["d_att"]
    V, L = model["vocab_size"], model["num_layers"]
    out = []

    def dense(name, n_in, n_out, bias=True):
        b = 1.0 / math.sqrt(n_in)
        out.append((f"{name}.weight", (n_out, n_in), b))
        if bias:
            out.append((f"{name}.bias", (n_out,), b))

    for mod, dim in model["modalities"]:
        dense(f"encoder.embed.{mod}", int(dim), E)
    out.append(("cell.word_embed.weight", (V, E), math.sqrt(3.0)))
    out.append(("cell.attention.score", (A,), 1.0 / math.sqrt(A)))
    dense("cell.attention.mem_proj", E, A, bias=False)
    dense("cell.attention.query_proj", H, A)
    for i in range(L):
        n_in = 2 * E if i == 0 else H
        out.append((f"cell.lstm.{i}.weight_i", (4 * H, n_in),
                    1.0 / math.sqrt(n_in)))
        out.append((f"cell.lstm.{i}.weight_h", (4 * H, H),
                    1.0 / math.sqrt(H)))
        out.append((f"cell.lstm.{i}.bias", (4 * H,), 1.0 / math.sqrt(H)))
    dense("cell.out_proj", H, V)
    for i in range(L):
        dense(f"init_c.{i}", E, H)
    for i in range(L):
        dense(f"init_h.{i}", E, H)
    return out


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf in float32 on ``device``, from one uniform draw of a
    ``torch.Generator`` seeded with ``seed``."""
    specs = leaf_specs(model)
    total = sum(math.prod(s) for _, s, _ in specs)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    flat = torch.rand(total, generator=g, device=device,
                      dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, bound in specs:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(bound)
        at += n
    return out


def load_into(module: torch.nn.Module, weights: dict[str, torch.Tensor]):
    """Copy ``weights`` into ``module``'s parameters by name, in each
    parameter's dtype; the names and shapes must match exactly."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"leaf names differ: model has {sorted(set(params) - set(weights))}"
            f", weights have {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{name}: shape {tuple(p.shape)} != "
                                 f"{tuple(w.shape)}")
            p.copy_(w.to(p.dtype))
