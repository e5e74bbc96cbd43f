"""The yardstick's arithmetic: peaks, the analytic FLOPs of a step and
each kernel's least work, all from shapes.

The FLOP model is a frozen copy of the port's ``obs/flops.py`` (matmuls
only, ``2*m*n*k``, the backward pass as twice the forward). A kernel's
work is the operations of the step's mathematics and each input byte
read once and each output byte written once, whatever implements it.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM5 data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
_PEAKS = {"h100 80gb hbm3": (PEAK_BF16_FLOPS, PEAK_HBM_BYTES)}


def peaks(device_name: str) -> tuple[float, float] | None:
    """(FLOP/s, bytes/s) of a card by a fragment of its name, or None."""
    name = device_name.lower()
    for frag, pk in _PEAKS.items():
        if frag in name:
            return pk
    return None


@dataclass(frozen=True)
class Dims:
    """A configuration's shapes: V, E, H, A, L, frames F, ``feat_dims``,
    memory slots M, max_len T, compute and parameter element bytes."""

    V: int
    E: int
    H: int
    A: int
    L: int
    F: int
    feat_dims: tuple[int, ...]
    M: int
    T: int
    act_bytes: int = 2
    param_bytes: int = 4

    @classmethod
    def of(cls, model: dict) -> "Dims":
        feat = tuple(int(d) for _, d in model["modalities"])
        F = int(model["max_frames"])
        M = len(feat) * F if model["encoder"] == "temporal_attention" \
            else len(feat)
        nbytes = {"bfloat16": 2, "float32": 4}
        return cls(V=int(model["vocab_size"]), E=int(model["d_embed"]),
                   H=int(model["d_hidden"]), A=int(model["d_att"]),
                   L=int(model["num_layers"]), F=F, feat_dims=feat, M=M,
                   T=int(model["max_len"]),
                   act_bytes=nbytes[model["dtype"]],
                   param_bytes=nbytes[model["param_dtype"]])


# ---- analytic FLOPs (frozen copy of obs/flops.py) ----------------------------

def enc_and_per_tok_flops(d: Dims) -> tuple[float, float]:
    """(encoder pass, one decoded token) matmul FLOPs of one row. The
    encoder's attention key projection covers the ``d.M`` slots."""
    E, H, A = d.E, d.H, d.A
    enc = 2 * d.F * sum(d.feat_dims) * E + 2 * d.M * E * A
    lstm = 2 * (E + E) * (4 * H) + 2 * H * (4 * H)
    lstm += (d.L - 1) * (2 * H * (4 * H) + 2 * H * (4 * H))
    per_tok = 2 * H * A + 2 * d.M * A + 2 * d.M * E + lstm + 2 * H * d.V
    return float(enc), float(per_tok)


def update_flops(d: Dims, clips: int, K: int) -> float:
    """REINFORCE updates of ``clips`` clips: one encoder pass and K
    teacher-forced rows of T steps a clip, forward and backward."""
    enc, tok = enc_and_per_tok_flops(d)
    return float(3 * clips * (enc + K * d.T * tok))


def xe_flops(d: Dims, rows: int) -> float:
    """XE steps over ``rows`` teacher-forced rows, forward and backward."""
    enc, tok = enc_and_per_tok_flops(d)
    return float(3 * rows * (enc + d.T * tok))


# ---- each kernel's least work -----------------------------------------------

def _weight_bytes(d: Dims) -> float:
    """The decode step's weights, read once: query projection and bias,
    score vector, LSTM input and hidden weights and bias, output
    projection and bias (the embedding rows are counted as gathered)."""
    H, A, E, L, V = d.H, d.A, d.E, d.L, d.V
    n = (H * A + 2 * A + (E + E) * 4 * H + (L - 1) * H * 4 * H
         + L * H * 4 * H + 4 * H + H * V + V)
    return float(n * d.param_bytes)


def _bank_bytes(d: Dims, rows: int) -> float:
    """A bank of ``rows`` clips: memory [M, E] and its projection [M, A]
    in the compute dtype, the mask [M] in float32."""
    return float(rows * d.M * ((d.E + d.A) * d.act_bytes + 4))


def _step_row_ops(d: Dims) -> float:
    H, A, E, L, V, M = d.H, d.A, d.E, d.L, d.V, d.M
    return float(2 * (H * A + (E + E) * 4 * H + (L - 1) * H * 4 * H
                      + L * H * 4 * H + H * V) + M * (4 * A + 2 * E)
                 + 10 * L * H)


def decode_step_work(d: Dims, G: int, B: int) -> tuple[float, float]:
    """Kernel 2, one launch over G lanes of B clips -> (operations,
    bytes): the step's matmuls and attention per row; the weights, the
    bank, the gathered embedding rows, the carry in and out and the
    float32 logits out."""
    ops = G * B * _step_row_ops(d)
    nbytes = (_weight_bytes(d) + _bank_bytes(d, B)
              + G * B * (d.E + 4 * d.L * d.H + d.V) * 4)
    return ops, nbytes


def attention_work(d: Dims, rows: int) -> tuple[float, float]:
    """Kernel 1, one forward launch over ``rows`` rows: per slot the
    A-wide add, tanh and multiply-add and the E-wide weighted sum; the
    query, score vector, bank and mask in, the [rows, E] context out."""
    ops = rows * d.M * (4 * d.A + 2 * d.E)
    nbytes = (rows * d.A * d.act_bytes + d.A * d.act_bytes
              + _bank_bytes(d, rows) + rows * d.E * d.act_bytes)
    return float(ops), float(nbytes)


def least_seconds(ops: float, nbytes: float, device_name: str) -> float:
    """The least time the card could take: operations over the bf16
    tensor-core peak or bytes over the HBM peak, whichever is larger."""
    pk = peaks(device_name)
    if pk is None:
        raise ValueError(f"no peaks for {device_name!r}")
    return max(ops / pk[0], nbytes / pk[1])
