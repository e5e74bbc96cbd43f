"""Frame-axis sequence parallelism over a ``('data', 'seq')`` grid of ranks
(the JAX package's ``parallel/seq_parallel.py``).

Every op of the caption model is frame-local except two: the attention
softmax (``models/attention.py``) and the carry-init masked mean
(``models/encoders.masked_mean``, ``models/captioner.py``). With the model
built by :func:`sp_model`, those two reduce over the row's group (the
ranks of one data coordinate, ``train.mesh.GridMesh.seq``): the max of the
scores, then one all-reduce of the (numerator, denominator) pair; the sums
of the pooled numerator and its count. Everything downstream of them is
the same on every rank of a row, bit for bit, so the decode loops run as
they are and step alike (``finished`` lies downstream of the sums).

Gradients. The JAX package takes them outside ``shard_map`` and lets its
varying-axis machinery place the collective transposes; autograd does not,
so the port spells the two conjugate operators out:

- :func:`seq_sum` (and :func:`seq_max`, under no grad): forward an
  all-reduce over the row, backward the identity. A row-partial sum's
  cotangent is the same on every rank already.
- :func:`seq_enter`: forward the identity, backward an all-reduce sum of
  the cotangent. A tensor replicated over the row that enters frame-local
  computation takes only this rank's partial cotangent there; the
  attention query (``query_proj(h)``) goes through it where it meets the
  local memory projection, so the replicated path behind it (the LSTM,
  ``query_proj``, ``init_c/h``) gets the exact gradient.

The parameters that enter frame-local computation (the per-frame
``embed_*`` layers, the attention's ``mem_proj`` and score vector;
:func:`frame_local_params`) are ``seq_enter``-ed once after the backward
instead: their gradients are summed over the row in one flat all-reduce
(:func:`row_reduce_grads`). The same all-reduce averages the other
(replicated) gradients over the row: equal on every rank in exact
arithmetic, and bitwise equal only where every backward kernel is
deterministic (on CUDA the embedding's accumulates with atomics), so the
average keeps a row's parameters, and so its decodes, in step. With
``meanpool`` the bank is ``[B, n_mod, E]`` and replicated after the pooled
sum, so the attention stays local and no parameter is frame-local.

Layout (one process a device): rank ``r`` is cell ``(r // S, r % S)``.
The batch shards by the data coordinate (``Batcher(host_shard=(d,
n_data))``), so every rank of a row collates the same videos, and each
keeps frames ``[s F/S, (s+1) F/S)`` of every modality
(:func:`shard_frames`). :func:`check_row_feed` is the port's counterpart
of the JAX package's refusal of a seq row that spans processes: a row
whose ranks hold other videos raises. Dropout and the rollout noise are keyed by the data
coordinate, never the seq one: the dropout sites all lie on the
replicated path, and equal masks keep it replicated.

The steps (:func:`make_sp_xe_step`, :func:`make_sp_rl_update`) sum the
loss's ``(num, den)`` over the data column and the gradients with the
data-parallel ``GradReducer`` over the column only, after the row sum of
the frame-local gradients. ``comm`` is f32 buckets: bf16 on the wire and
overlap are refused on this path (``config.py``), as in the JAX package.

:data:`COUNTS` counts this module's collectives and their bytes on the
host (``reset_counts``), for the per-step numbers chip_smoke.py prints.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
import torch.distributed as dist

# collectives launched by this module since reset_counts(): calls and
# bytes a rank, by operator
COUNTS: dict[str, int] = {}


def reset_counts() -> None:
    COUNTS.clear()


def _count(op: str, t: torch.Tensor) -> None:
    COUNTS[op] = COUNTS.get(op, 0) + 1
    COUNTS[op + "_bytes"] = (COUNTS.get(op + "_bytes", 0)
                             + t.numel() * t.element_size())


def row_of(mesh):
    """The row (the seq axis) of a ``GridMesh``, or ``mesh`` itself when it
    is a row already (a ``DataMesh``) or None."""
    return getattr(mesh, "seq", mesh)


def _group(row):
    """The row's process group, or None for a row of one rank (the
    collectives are then the identity)."""
    if row is None or row.world == 1 or row.group is None:
        return None
    return row.group


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in float32 -> a new tensor of ``t``'s
    dtype."""
    y = t.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, op=op, group=group)
    return y.to(t.dtype)


class _SeqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SeqEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count("seq_enter", g)
        return _all_reduce(g, ctx.group), None


def seq_sum(x: torch.Tensor, row) -> torch.Tensor:
    """Sum of ``x`` over the row's ranks (forward), the identity on the
    cotangent (backward). The sum runs in float32."""
    group = _group(row)
    if group is None:
        return x
    _count("seq_sum", x)
    return _SeqSum.apply(x, group)


def seq_max(x: torch.Tensor, row) -> torch.Tensor:
    """Elementwise max of ``x`` over the row's ranks, outside autograd
    (the softmax's shift: a constant for the gradient)."""
    x = x.detach()
    group = _group(row)
    if group is None:
        return x
    _count("seq_max", x)
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def seq_enter(x: torch.Tensor, row) -> torch.Tensor:
    """``x`` as it is (forward); its cotangent summed over the row's ranks
    (backward): where a row-replicated tensor enters frame-local work."""
    group = _group(row)
    if group is None or not x.requires_grad:
        return x
    return _SeqEnter.apply(x, group)


# ---- the model and the batch layout -------------------------------------------


def sp_model(cfg, mesh, device=None, seq_axis: str = "seq"):
    """A ``CaptionModel`` whose frame-axis reductions run over ``mesh``'s
    row (a ``GridMesh``, or the row ``DataMesh`` itself), built on
    ``device`` (default the mesh's). Its parameters are layout-identical
    to the unsharded model's: checkpoints load either way."""
    from cst_captioning_tpu_torch.models import CaptionModel

    row = row_of(mesh)
    model = CaptionModel(dataclasses.replace(cfg, seq_axis=seq_axis),
                         device=device if device is not None else row.device)
    model.set_seq(row, seq_axis)
    return model


def sp_batch_specs(cfg, data_axis: str = "", seq_axis: str = "seq"):
    """(feats_specs, masks_specs): per modality the spec of its ``[B, F,
    ...]`` array, a tuple of axis names (None: not sharded), the frame
    axis on ``seq_axis`` and the batch axis on ``data_axis`` (replicated
    when empty)."""
    b = data_axis if data_axis else None
    feats = {name: (b, seq_axis) for name, _ in cfg.modalities}
    masks = {name: (b, seq_axis) for name, _ in cfg.modalities}
    return feats, masks


def sp_batch_shardings(mesh, cfg, data_axis: str = "data",
                       seq_axis: str = "seq") -> tuple:
    """The specs of the XE batch tuple ``(feats, masks, labels, mask,
    weights, valid)`` on the grid: frames over ``seq_axis``, rows over
    ``data_axis``. A rank's rows come from the host-sharded Batcher;
    :func:`shard_frames` cuts its frames."""
    del mesh  # the specs name axes only
    f, m = sp_batch_specs(cfg, data_axis, seq_axis)
    d = (data_axis,)
    return f, m, d, d, d, d


def shard_frames(mesh, tree: dict) -> dict:
    """This rank's frames ``[s F/S, (s+1) F/S)`` of every ``[B, F, ...]``
    entry of a ``{modality: array}`` dict (numpy arrays or tensors; the
    rows host-local already)."""
    row = row_of(mesh)
    out = {}
    for k, x in tree.items():
        F = x.shape[1]
        if F % row.world:
            raise ValueError(f"{F} frames do not divide over {row.world} "
                             "ranks")
        n = F // row.world
        x = x[:, row.rank * n:(row.rank + 1) * n]
        out[k] = x.contiguous() if isinstance(x, torch.Tensor) else \
            np.ascontiguousarray(x)
    return out


def check_row_feed(mesh, video_ids) -> None:
    """Every rank of a seq row must collate the same videos. Each rank
    hashes ``video_ids`` (its shard of an epoch's order); the hashes are
    gathered across the grid, and a row whose ranks disagree raises on
    every rank."""
    from cst_captioning_tpu_torch.train import multihost

    h = hashlib.sha256("\n".join(str(v) for v in video_ids).encode())
    every = multihost.allgather_pyobj(h.hexdigest())
    S = mesh.seq.world
    for d in range(mesh.data.world):
        row = every[d * S:(d + 1) * S]
        if len(set(row)) > 1:
            raise ValueError(
                f"seq row {d} (ranks {d * S}..{d * S + S - 1}) collates "
                "different videos on its ranks: sequence parallelism feeds "
                "every rank of a row the same rows, sharded by the data "
                "coordinate (Batcher(host_shard=(rank // seq_devices, "
                "world // seq_devices))), and sums their frame shards")


# ---- gradients ------------------------------------------------------------------


def frame_local_params(model) -> list[int]:
    """Indices (``model.parameters()`` order) of the parameters whose
    gradient a rank holds only its frames' share of: on a frame-sharded
    bank (``temporal_attention``) the per-frame ``embed_*`` layers, the
    attention's ``mem_proj`` and score vector; none at ``meanpool``."""
    if model.cfg.encoder != "temporal_attention":
        return []
    local = ("encoder.embed.", "cell.attention.mem_proj.",
             "cell.attention.score")
    return [i for i, (n, _) in enumerate(model.named_parameters())
            if n.startswith(local)]


def row_reduce_grads(grads, local: list[int], row) -> list:
    """``grads`` reduced over the row's ranks in one flat float32
    all-reduce: the entries at ``local`` (the frame-local parameters')
    summed, the others averaged (for two ranks, or any power of two, an
    average of equal values is exact), each rounded back to its own dtype
    once (a bfloat16 leaf's sum is taken in float32)."""
    grads = list(grads)
    group = _group(row)
    if group is None:
        return grads
    scale = 1.0 / row.world
    flat = torch.cat([g.reshape(-1).float() * (1.0 if i in local else scale)
                      for i, g in enumerate(grads)])
    _count("row_grads", flat)
    dist.all_reduce(flat, group=group)
    off = 0
    for i, g in enumerate(grads):
        grads[i] = flat[off:off + g.numel()].view_as(g).to(g.dtype)
        off += g.numel()
    return grads


# ---- forward, decode and the steps ------------------------------------------------


def make_sp_forward(model, mesh):
    """-> fwd(model, feats, masks, labels) -> logits [B, T, V] float32 of
    this rank's rows (frames: its shard), the same on every rank of a
    row (they lie downstream of the attention sums). ``model`` is an
    :func:`sp_model` over ``mesh``'s row."""
    del model, mesh  # the call names the model; its row is built in

    def fwd(model, feats, masks, labels):
        return model(feats, masks, labels)

    return fwd


def make_sp_decode(model, mesh, num_rollouts: int = 0,
                   temperature: float = 1.0, max_len: int | None = None,
                   with_greedy: bool = True, fused: bool = True):
    """-> decode(model, feats, masks, seed, noise_fn=None) -> (greedy [B, T]
    or None, samples [K, B, T], or the greedy tokens again when
    ``num_rollouts`` is 0), decoding this rank's rows over its frame
    shard: ``rl.scst.make_parallel_rl_decode`` on the grid, whose rollout
    noise is that of the rows' global indices, the data coordinate times
    B, so a grid's rollouts equal the one-rank decode's. ``with_greedy``
    and ``fused`` as there."""
    from cst_captioning_tpu_torch.decoding.greedy import greedy_decode
    from cst_captioning_tpu_torch.rl.scst import make_parallel_rl_decode

    if not num_rollouts and not with_greedy:
        raise ValueError("nothing to decode: num_rollouts=0 and no greedy")
    if num_rollouts:
        return make_parallel_rl_decode(model, mesh, num_rollouts,
                                       temperature, max_len, with_greedy,
                                       fused)

    def decode(model, feats, masks, seed: int, noise_fn=None):
        greedy, _ = greedy_decode(model, feats, masks, max_len=max_len)
        return greedy, greedy

    return decode


def _reducers(model, mesh, comm):
    """The column's gradient all-reduce and the frame-local index."""
    from cst_captioning_tpu_torch.parallel.comms import GradReducer
    from cst_captioning_tpu_torch.train.mesh import param_leaves

    return (GradReducer(param_leaves(model), mesh.data, comm),
            frame_local_params(model))


def _finish(state, num, den, g, mesh, reducer, local, guard, stats, key,
            promote: bool = False):
    """Reduce the gradients over the row (:func:`row_reduce_grads`), sum
    (num, den) and the gradients over the column, divide by the global
    ``max(den, 1)`` and apply -> (state, metrics). ``promote``: divide as
    ``train.steps.divide_grads`` (the JAX chunked SP update divides by a
    float32 array, which widens bfloat16 gradients; its XE step and
    unchunked update differentiate the divided loss and keep the leaf
    dtype)."""
    from cst_captioning_tpu_torch.parallel.comms import reduce_sums
    from cst_captioning_tpu_torch.train.schedule import global_norm
    from cst_captioning_tpu_torch.train.steps import _apply, divide_grads

    g = row_reduce_grads(g, local, mesh.seq)
    num_t, den_t = reduce_sums(num, den, mesh.data)
    den_t = torch.clamp(den_t, min=1.0)
    g = reducer(g)
    grads = divide_grads(g, den_t) if promote else [x / den_t for x in g]
    return _apply(state, grads, num_t / den_t,
                  global_norm(grads, state.leaves), guard, key=key,
                  stats=stats)


def make_sp_xe_step(model, mesh, label_smoothing: float = 0.0,
                    guard: bool = False, comm=None, stats: bool = False):
    """-> step(state, feats, masks, labels, mask, weights) -> (state,
    metrics): the XE step on a grid (``mesh``, a ``GridMesh``; ``model``
    an :func:`sp_model` over its row), this rank's rows and frames. The
    dropout masks are the data coordinate's (the data-parallel step's of
    that rank); the loss and its gradients are those of the one-device
    step on the global batch up to float summation order, the same on
    every rank."""
    from cst_captioning_tpu_torch.train.steps import _local_loss_sums

    reducer, local = _reducers(model, mesh, comm)

    def step(state, feats, masks, labels, mask, weights):
        num, den = _local_loss_sums(state, feats, masks, labels, mask,
                                    weights, label_smoothing, mesh.data.rank)
        g = torch.autograd.grad(num, state.params)
        return _finish(state, num, den, g, mesh, reducer, local, guard,
                       stats, "loss")

    return step


def make_sp_rl_update(model, mesh, chunks: int = 1, guard: bool = False,
                      comm=None, stats: bool = False):
    """-> update(state, feats, masks, samples [K, B, T], advantage [K, B],
    valid [B]) -> (state, metrics): the REINFORCE update on a grid, in the
    sum form of ``rl.scst.make_parallel_rl_update``. ``chunks > 1``
    accumulates over slices of the rollout axis with one encoder pass,
    the encoder-output cotangents summed in float32 and one backward
    through the encoder (``rl.scst._chunked_loss_grads``)."""
    from cst_captioning_tpu_torch.rl.scst import (
        _chunked_loss_grads,
        _decode_loss_sums,
        _tile_enc,
    )

    reducer, local = _reducers(model, mesh, comm)

    def update(state, feats, masks, samples, advantage, valid):
        model = state.model
        params = state.params
        if chunks > 1:
            num, den, g = _chunked_loss_grads(
                model, params, feats, masks, samples, advantage, valid,
                chunks)
        else:
            K, B, T = samples.shape
            enc = model.encode(feats, masks)
            num, den = _decode_loss_sums(
                model, _tile_enc(enc, K), samples.reshape(K * B, T),
                advantage.reshape(K * B), valid.repeat(K))
            g = torch.autograd.grad(num, params)
        return _finish(state, num, den, g, mesh, reducer, local, guard,
                       stats, "rl_loss", promote=chunks > 1)

    return update
