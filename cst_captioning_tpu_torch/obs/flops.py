"""Analytic matmul-FLOP cost models + the card peak table (pure stdlib).

One source of truth for the numbers its consumers would otherwise
duplicate:

- the trainer / SCST loop / serving engine: per-step ``flops.<phase>``
  counters feeding the run report's MFU column (``obs/report.py``);
- ``cli.obs_report``, which aggregates without importing torch, hence
  everything here is plain arithmetic over ints.

Conventions (the JAX package's model, unchanged, so both packages count
equal integers): FLOPs count matmuls only as ``2*m*n*k``;
elementwise/softmax work is ignored (the model is matmul-dominated); the
backward pass is taken as 2x the forward (3x overall). ``E`` below is the
encoder output dim (== ``d_embed``: every modality is embedded to
``d_embed`` and concatenated on the frame axis, so ``M = n_modalities *
F``).
"""

from __future__ import annotations

# Peak dense BF16 tensor-core FLOP/s (without sparsity) and HBM bytes/s of
# NVIDIA cards, keyed on a fragment of ``torch.cuda.get_device_name()``.
# These are NVIDIA's published datasheet peaks at each card's full power
# limit (SXM5 700 W, PCIe 350 W), not measurements. The
# match is a case-blind substring of the name; a card the table does not
# hold has no peak (0.0), and the report then leaves its MFU column blank.
PEAK_BF16_FLOPS = (
    ("h100 80gb hbm3", 989e12),   # H100 SXM5 80GB ("NVIDIA H100 80GB HBM3")
    ("h100 pcie", 756e12),        # H100 PCIe ("NVIDIA H100 PCIe")
)
PEAK_HBM_BYTES = (
    ("h100 80gb hbm3", 3.35e12),
    ("h100 pcie", 2.0e12),
)


def _lookup(table, device_name: str) -> float:
    name = device_name.lower()
    for frag, peak in table:
        if frag in name:
            return peak
    return 0.0


def peak_flops(device_name: str) -> float:
    """Datasheet peak dense BF16 FLOP/s for a ``device_name``; 0.0 for a
    card the table does not hold."""
    return _lookup(PEAK_BF16_FLOPS, device_name)


def peak_hbm(device_name: str) -> float:
    """Datasheet peak HBM bytes/s for a ``device_name``; 0.0 for a card the
    table does not hold."""
    return _lookup(PEAK_HBM_BYTES, device_name)


def enc_and_per_tok_flops(
    F: int, d_embed: int, d_hidden: int, d_att: int, V: int,
    feat_dims: tuple[int, ...], num_layers: int = 1,
) -> tuple[float, float]:
    """(encoder-pass, per-decoded-token) matmul FLOPs of the caption model.

    Encoder: per-modality frame embeddings + the attention memory-key
    projection. Per token: additive attention (query proj, scores, context
    sum over the M-slot concat memory), the input-feed LSTM stack (layer 0
    input is ``[word_emb, ctx]`` = ``2*d_embed``), and the output
    projection.
    """
    M = len(feat_dims) * F
    E, H, A = d_embed, d_hidden, d_att
    enc = 2 * F * sum(feat_dims) * E + 2 * M * E * A
    lstm = 2 * (E + E) * (4 * H) + 2 * H * (4 * H)        # layer 0
    lstm += (num_layers - 1) * (2 * H * (4 * H) + 2 * H * (4 * H))
    per_tok = (
        2 * H * A          # attention query projection
        + 2 * M * A        # scores
        + 2 * M * E        # context weighted sum
        + lstm
        + 2 * H * V        # output projection
    )
    return float(enc), float(per_tok)


def stride_steps(T: int, stride: int = 1) -> int:
    """Scan-step budget of a strided decode loop: T rounded up to the next
    stride multiple (the driving loop advances whole strides, so the final
    partial chunk still steps ``stride`` times)."""
    s = max(int(stride), 1)
    return -(-int(T) // s) * s


def decode_flops_per_clip(
    K: int, T: int, F: int, d_embed: int, d_hidden: int, d_att: int, V: int,
    feat_dims: tuple[int, ...], num_layers: int = 1,
    with_greedy: bool = True, fused: bool = True,
    stride: int = 1, active_frac: float = 1.0,
) -> float:
    """Matmul FLOPs of one RL decode per clip.

    ``fused=True`` (the one-loop default): ONE encoder pass feeds both
    the greedy lane and the K sampled lanes. ``fused=False`` is the two-loop
    reference: greedy and sampling each run their own encoder pass.

    ``stride`` rounds the step budget up to whole driving-loop chunks
    (``decode_stride``); ``active_frac`` scales the per-token work by the
    fraction of lane-steps actually computed — 1.0 assumes every lane steps
    the full budget (the uncompacted worst case), while a measured value
    from the ``rl.decode.compaction`` counters (lanes_stepped /
    (lanes_stepped + lanes_skipped)) gives the compaction-aware cost.
    """
    enc, per_tok = enc_and_per_tok_flops(
        F, d_embed, d_hidden, d_att, V, feat_dims, num_layers
    )
    lanes = (1 if with_greedy else 0) + K
    enc_passes = 1 if (fused or not with_greedy) else 2
    steps = stride_steps(T, stride)
    return float(enc_passes * enc + lanes * steps * per_tok * active_frac)


def serving_bank_bytes_per_stride(
    rows: int, width_slots: int, d_embed: int, d_att: int,
    dtype_bytes: int = 4, paged: bool = False,
) -> float:
    """Encoder-bank HBM bytes one serving stride moves, per decode path.

    The bank is ``rows`` lanes x ``width_slots`` memory slots of
    ``(E mem + A proj + 1 mask)`` elements. The dense-gather path pays it
    THREE times per stride: the gather reads the pool, writes the dense
    [B, W, *] bank, and the stride kernel reads the bank back. The paged
    in-kernel path DMAs each batch block's pages from the pool into VMEM
    exactly once — one read, no dense bank — so its cost is the bank bytes
    themselves. ``serving.gather_bytes_avoided`` counts the difference
    (2x the bank) per paged stride dispatch. One ``dtype_bytes`` covers
    all three pools (the mask pool is f32 even under a bf16 model — at
    bf16 this overstates mask traffic by 2 of ~E+A+1 elements; the model
    stays deliberately simple)."""
    bank = float(rows) * width_slots * (d_embed + d_att + 1) * dtype_bytes
    return bank if paged else 3.0 * bank


def update_flops_per_clip(
    K: int, T: int, F: int, d_embed: int, d_hidden: int, d_att: int, V: int,
    feat_dims: tuple[int, ...], num_layers: int = 1,
) -> float:
    """Matmul FLOPs of one REINFORCE update per clip: one encoder pass, K
    teacher-forced rollout rows, forward+backward as 3x forward."""
    enc, per_tok = enc_and_per_tok_flops(
        F, d_embed, d_hidden, d_att, V, feat_dims, num_layers
    )
    return float(3 * (enc + K * T * per_tok))


def xe_flops_per_row(
    T: int, F: int, d_embed: int, d_hidden: int, d_att: int, V: int,
    feat_dims: tuple[int, ...], num_layers: int = 1,
) -> float:
    """Matmul FLOPs of one teacher-forced XE row (forward+backward)."""
    enc, per_tok = enc_and_per_tok_flops(
        F, d_embed, d_hidden, d_att, V, feat_dims, num_layers
    )
    return float(3 * (enc + T * per_tok))


# ---- the compiled-cost hook ----------------------------------------------------
#
# The JAX package reads XLA's cost analysis of a compiled program here. A
# PyTorch program has no compiled-program cost to read, so the port's
# counterpart returns the analytic count it is given, labelled as such:
# the ``flops.backend.<phase>`` gauges then read 0.0 ("analytic") and the
# report tags the MFU cell "a".


def compiled_cost(flops: float, bytes_accessed: float = 0.0) -> dict:
    """``{"flops", "bytes_accessed", "backend": "analytic"}`` of a program
    whose analytic cost the caller computed (``stride_cost``, the step
    counters)."""
    return {"flops": float(flops), "bytes_accessed": float(bytes_accessed),
            "backend": "analytic"}
