"""JAX/flax parameter trees <-> the port's modules.

The tree is nested dicts of numpy arrays, as ``jax.tree.map(np.asarray,
params)`` gives it (the top-level ``"params"`` key may be present or not).
The mapping:

- a flax ``Dense`` kernel ``[in, out]`` becomes ``weight = kernel.T``;
- the ``OptimizedLSTMCell`` per-gate kernels ``i{g}`` (no bias) and
  ``h{g}`` (with bias) are concatenated in ``LSTM_GATE_ORDER``;
- ``attention/score/kernel [A, 1]`` becomes the vector ``score [A]``;
- ``word_embed/embedding [V, E]`` is the ``nn.Embedding`` weight as is.

:func:`state_dict_to_flax` is the inverse, for parameters and for
gradients keyed like the state dict. Reading a flax msgpack checkpoint
needs flax or msgpack and comes with the checkpoint slice.

A ``bfloat16`` leaf (an ``ml_dtypes`` array as JAX gives it, or its
``uint16`` bit patterns, the form the port's checkpoints and msgpack
reader keep it in: numpy has no bfloat16 of its own) becomes a bfloat16
tensor through its bits, exactly; every other leaf a float32 tensor. A
model stores what it loads in its ``param_dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from cst_captioning_tpu_torch.config import ModelConfig
from cst_captioning_tpu_torch.models.decoder import LSTM_GATE_ORDER


def _leaf(x) -> torch.Tensor:
    """A flax leaf as a CPU tensor: bfloat16 leaves (by dtype name, or as
    uint16 bits) through their bits, anything else as float32."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor's uint16 bit patterns on the host."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def flax_to_state_dict(cfg: ModelConfig, tree) -> dict[str, torch.Tensor]:
    """A ``CaptionModel`` state dict (CPU tensors, float32 or bfloat16 as
    the leaves are) from a flax tree."""
    p = tree.get("params", tree)
    sd: dict[str, torch.Tensor] = {}

    def dense(prefix, d, bias=True):
        sd[f"{prefix}.weight"] = _leaf(d["kernel"]).T.contiguous()
        if bias:
            sd[f"{prefix}.bias"] = _leaf(d["bias"])

    for name, _ in cfg.modalities:
        dense(f"encoder.embed.{name}", p["encoder"][f"embed_{name}"])
    cell = p["cell"]
    sd["cell.word_embed.weight"] = _leaf(cell["word_embed"]["embedding"])
    att = cell["attention"]
    dense("cell.attention.mem_proj", att["mem_proj"], bias=False)
    dense("cell.attention.query_proj", att["query_proj"])
    sd["cell.attention.score"] = _leaf(att["score"]["kernel"])[:, 0].contiguous()
    for layer in range(cfg.num_layers):
        lp = cell[f"lstm{layer}"]
        cat = lambda fam, leaf: np.concatenate(  # noqa: E731
            [lp[f"{fam}{g}"][leaf] for g in LSTM_GATE_ORDER], axis=-1
        )
        sd[f"cell.lstm.{layer}.weight_i"] = _leaf(cat("i", "kernel")).T.contiguous()
        sd[f"cell.lstm.{layer}.weight_h"] = _leaf(cat("h", "kernel")).T.contiguous()
        sd[f"cell.lstm.{layer}.bias"] = _leaf(cat("h", "bias"))
        dense(f"init_c.{layer}", p[f"init_c{layer}"])
        dense(f"init_h.{layer}", p[f"init_h{layer}"])
    dense("cell.out_proj", cell["out_proj"])
    return sd


def state_dict_to_flax(cfg: ModelConfig, sd, bits: bool = False) -> dict:
    """A flax tree ``{"params": ...}`` of float32 numpy arrays from a
    ``CaptionModel`` state dict, or from gradients keyed like one; a
    bfloat16 tensor widens exactly, or with ``bits`` comes out as its
    uint16 bit patterns (the port's checkpoint format)."""
    a = {k: _bf16_bits(v) if bits and v.dtype == torch.bfloat16
         else v.detach().float().cpu().numpy() for k, v in sd.items()}

    def dense(prefix, bias=True):
        d = {"kernel": np.ascontiguousarray(a[f"{prefix}.weight"].T)}
        if bias:
            d["bias"] = a[f"{prefix}.bias"]
        return d

    H = cfg.d_hidden
    cell = {
        "word_embed": {"embedding": a["cell.word_embed.weight"]},
        "attention": {
            "mem_proj": dense("cell.attention.mem_proj", bias=False),
            "query_proj": dense("cell.attention.query_proj"),
            "score": {"kernel": a["cell.attention.score"][:, None]},
        },
        "out_proj": dense("cell.out_proj"),
    }
    params = {
        "encoder": {f"embed_{n}": dense(f"encoder.embed.{n}")
                    for n, _ in cfg.modalities},
        "cell": cell,
    }
    for layer in range(cfg.num_layers):
        wi = a[f"cell.lstm.{layer}.weight_i"].T
        wh = a[f"cell.lstm.{layer}.weight_h"].T
        b = a[f"cell.lstm.{layer}.bias"]
        lstm = {}
        for k, g in enumerate(LSTM_GATE_ORDER):
            cols = slice(k * H, (k + 1) * H)
            lstm[f"i{g}"] = {"kernel": np.ascontiguousarray(wi[:, cols])}
            lstm[f"h{g}"] = {"kernel": np.ascontiguousarray(wh[:, cols]),
                             "bias": b[cols]}
        cell[f"lstm{layer}"] = lstm
        params[f"init_c{layer}"] = dense(f"init_c.{layer}")
        params[f"init_h{layer}"] = dense(f"init_h.{layer}")
    return {"params": params}


def load_flax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a flax tree into ``model`` (a ``CaptionModel``) in place, each
    leaf cast to the parameter's dtype (exact when the leaf holds values
    of that dtype)."""
    sd = flax_to_state_dict(model.cfg, tree)
    model.load_state_dict(sd, strict=True)
    return model


def random_flax_params(cfg: ModelConfig, seed: int, eos_bias: float = 0.0):
    """Seeded random weights in the flax tree layout (float32 numpy),
    scaled like flax's default initializers (kernels ~ N(0, 1/fan_in), zero
    biases). ``eos_bias`` is added to the output bias at EOS so caption
    lengths vary under random weights. For ``param_dtype="bfloat16"`` every
    value is rounded to bfloat16 (still float32 arrays), so a bf16 model
    and a float32 one load the same values."""
    from cst_captioning_tpu_torch.config import EOS_ID

    rng = np.random.default_rng(seed)
    E, H, A, V = cfg.d_embed, cfg.d_hidden, cfg.d_att, cfg.vocab_size

    def dense(n_in, n_out, bias=True):
        d = {"kernel": (rng.standard_normal((n_in, n_out), np.float32)
                        / np.float32(np.sqrt(n_in)))}
        if bias:
            d["bias"] = np.zeros((n_out,), np.float32)
        return d

    cell = {
        "word_embed": {"embedding": rng.standard_normal((V, E), np.float32)
                       / np.float32(np.sqrt(E))},
        "attention": {
            "mem_proj": dense(E, A, bias=False),
            "query_proj": dense(H, A),
            "score": dense(A, 1, bias=False),
        },
        "out_proj": dense(H, V),
    }
    cell["out_proj"]["bias"][EOS_ID] += np.float32(eos_bias)
    params = {
        "encoder": {f"embed_{n}": dense(d, E) for n, d in cfg.modalities},
        "cell": cell,
    }
    for layer in range(cfg.num_layers):
        n_in = 2 * E if layer == 0 else H
        lstm = {}
        for g in LSTM_GATE_ORDER:
            lstm[f"i{g}"] = dense(n_in, H, bias=False)
            lstm[f"h{g}"] = dense(H, H)
        cell[f"lstm{layer}"] = lstm
        params[f"init_c{layer}"] = dense(E, H)
        params[f"init_h{layer}"] = dense(E, H)
    if cfg.param_dtype == "bfloat16":
        params = _map(lambda a: torch.from_numpy(a).to(torch.bfloat16)
                      .float().numpy(), params)
    return {"params": params}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
