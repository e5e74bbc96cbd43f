"""Sharded-vocab decode over an ``'mp'`` group of ranks (the JAX package's
``ops/decode_mp.py``).

The output projection ``[H, V]`` and the embedding table ``[V, E]`` split
over the ranks of an ``'mp'`` row (``train.mesh.make_mesh(mp_devices=M)``:
a ``GridMesh`` whose ``.mp`` is the row, or that row's ``DataMesh``
itself): rank ``k`` of the row holds the vocabulary slice ``[off, off +
V_s)``, ``off = k * V_s``, ``V_s = V / M``. Each rank runs kernel 2, the
port's ``fused_decode_step`` (``ops/decode_step.py``), unchanged on its
slice, with the embedding rows given (``emb=``), as the JAX package calls
its ``fused_decode_step`` on each shard. The recurrent weights stay
replicated: the kernel consumes them whole. The replicated kernels' token
stream comes back through the JAX merges, each spelled as the same
collectives on the row's process group:

- the next token's embedding: a masked local gather (rows the slice does
  not own are zeros) and one all-reduce sum (:func:`_psum_embed`), exact
  because one rank owns each id;
- argmax (the greedy lane, and the Gumbel-max of the sampled lanes): each
  rank's first local max with its GLOBAL index, both all-gathered, ties to
  the lowest rank, which is the lowest global index because the slices are
  ordered (:func:`_merge_argmax`); bit-exact;
- logsumexp: the max all-reduced, then the sum of ``exp(x - m)``
  all-reduced (:func:`_merge_lse`); logprobs sit within a few f32 ulps of
  the one-shot reduction;
- the selected logit, summed from its owning rank (:func:`_psum_select`);
- beam top-W: each rank's top W of its ``[B, W * V_s]`` slice with flat
  ids rebased to the replicated kernel's ``w * V + off + v``, both
  all-gathered, and W elimination passes (:func:`_merge_topw`) that keep
  the replicated order: a strictly greater score first, equal scores to
  the lower flat id.

PAD and BOS are masked (EOS while ``t < min_len``) by global id on the rank
that owns it (:func:`_set_owned`); kernel 2 writes raw logits. ``noise``
``[S, K, B, V]`` is sliced on its vocab dimension, as the JAX
``in_specs`` ``P(None, None, None, axis)`` shards it.

An all-gather is an all-reduce sum of a buffer that holds this rank's
block in its slot and zeros elsewhere: exact, and a collective gloo runs
on CUDA tensors as well as on the host. :data:`COUNTS` counts every
collective a rank starts and its bytes (``reset_counts``); a stride step
is the JAX spelling's 8 (one embedding sum, two argmax merges of two
gathers, the max and the sum of the logsumexp, the selected logit), a
beam step 5.

A shard packs its own contiguous ``wo [H, V_s]``, ``bo [V_s]`` and ``embt
[V_s, E]`` (:func:`shard_weights`, once a model or publish; the callers
pass it as ``weights=``). On CPU tensors kernel 2's wrapper runs its plain
version, with the same merges over the group (gloo); on CUDA tensors it
launches the kernel or raises. The JAX ``_stride_program`` and
``_beam_program`` caches have no counterpart: the port compiles nothing.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_tpu_torch.ops.beam_step import top_w
from cst_captioning_tpu_torch.ops.decode_step import (
    fused_decode_step_,
    stack_carry,
    unstack_carry,
)
from cst_captioning_tpu_torch.ops.decode_stride import (
    NEG,
    StrideWeights,
    stride_weights,
)
from cst_captioning_tpu_torch.train.mesh import (
    MP_PARAM_PARTITION_RULES,
    GridMesh,
    match_rule,
    mp_row,
    param_path_names,
)

# the decode path shards only the vocab dimension; these are the rule
# families (train/mesh.py) that carry it
VOCAB_FAMILIES = ("word_embed", "output_head_kernel", "output_head_bias")

# collectives a rank started since reset_counts(): calls and bytes by
# operator
COUNTS: dict[str, int] = {}


def reset_counts() -> None:
    COUNTS.clear()


def _count(op: str, t: torch.Tensor) -> None:
    COUNTS[op] = COUNTS.get(op, 0) + 1
    COUNTS[op + "_bytes"] = (COUNTS.get(op + "_bytes", 0)
                             + t.numel() * t.element_size())


def mp_cell_specs(model, axis: str = "mp") -> dict:
    """The decoder cell's specs on the decode path, nested as the JAX cell
    subtree (``spec["out_proj"]["kernel"]``): the vocab families shard over
    ``axis`` as ``MP_PARAM_PARTITION_RULES`` says, everything else (the
    recurrent weights the kernel consumes whole) is replicated, ``()``.
    ``model`` is a ``CaptionModel`` (its ``param_path_names``)."""
    out: dict = {}
    prefix = "params/cell/"
    for name in param_path_names(model):
        if not name.startswith(prefix):
            continue
        family, spec = match_rule(MP_PARAM_PARTITION_RULES, name)
        if family not in VOCAB_FAMILIES:
            spec = ()
        elif axis != "mp":
            spec = tuple(axis if a == "mp" else a for a in spec)
        *path, leaf = name[len(prefix):].split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = spec
    return out


def shard_weights(w: StrideWeights, shard: int, mp: int) -> StrideWeights:
    """The packed weights of vocabulary slice ``shard`` of ``mp``, in the
    pack's dtype: contiguous copies of its ``wo``, ``bo`` and ``embt``
    columns and rows, the recurrent weights shared with ``w``."""
    vs = w.bo.shape[0] // mp
    cols = slice(shard * vs, (shard + 1) * vs)
    return dataclasses.replace(
        w, wo=w.wo[:, cols].contiguous(), bo=w.bo[cols].contiguous(),
        embt=w.embt[cols].contiguous())


# ---- the merges --------------------------------------------------------------


def _row(mesh):
    """The ranks the vocabulary shards over: a ``('data', 'mp')`` grid's
    row (``train.mesh.mp_row``), or an mp row passed as the mesh itself."""
    row = mp_row(mesh)
    if row is not None:
        return row
    if isinstance(mesh, GridMesh):
        raise ValueError(f"a {mesh.axis_names!r} grid has no 'mp' row to "
                         "shard the vocabulary over")
    return mesh


def _group(row):
    return None if row.world == 1 else row.group


def _all_reduce(t: torch.Tensor, row, op_name: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the row in place (the identity for one rank)."""
    group = _group(row)
    if group is not None:
        _count(op_name, t)
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, row) -> torch.Tensor:
    """[*] -> [mp, *]: every rank's ``t`` in rank order (module
    docstring: an all-reduce sum over zero slots)."""
    buf = torch.zeros((row.world,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    buf[row.rank] = t
    return _all_reduce(buf, row, "all_gather")


def _set_owned(x: torch.Tensor, global_id: int, off: int,
               value: float) -> torch.Tensor:
    """``x[..., global_id] = value`` in place where this slice ``[off, off
    + V_s)`` owns the id; the identity elsewhere."""
    li = global_id - off
    if 0 <= li < x.shape[-1]:
        x[..., li] = value
    return x


def _owned(idx: torch.Tensor, off: int, vs: int):
    """(owned mask, local index clipped into the slice) of global ids."""
    li = idx.long() - off
    return (li >= 0) & (li < vs), li.clamp(0, vs - 1)


def _psum_embed(table: torch.Tensor, token: torch.Tensor, off: int, row):
    """Masked local gather + one all-reduce sum: the row-sharded embedding
    lookup ``[G, B] -> [G, B, E]`` (one rank owns each id, the rest add
    zeros)."""
    owned, lic = _owned(token, off, table.shape[0])
    rows = torch.where(owned[..., None], table[lic],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    return _all_reduce(rows.contiguous(), row, "psum_embed")


def _merge_argmax(vals: torch.Tensor, off: int, row) -> torch.Tensor:
    """Global first-index argmax over vocab-sharded ``vals [..., V_s]``:
    each rank's first local max and its global index, all-gathered; ties
    across ranks go to the lowest rank, which holds the lowest index."""
    lv, li = vals.max(dim=-1)
    li = li.to(torch.int32) + off
    avs = _all_gather(lv.contiguous(), row)            # [mp, ...]
    ais = _all_gather(li.contiguous(), row)
    sel = torch.argmax(avs, dim=0)
    return torch.gather(ais, 0, sel[None])[0]


def _merge_lse(logits: torch.Tensor, row) -> torch.Tensor:
    """Logsumexp across the vocab shards: the max all-reduced, then the
    sum of ``exp(x - m)`` all-reduced."""
    m = _all_reduce(logits.max(dim=-1).values.contiguous(), row, "pmax",
                    dist.ReduceOp.MAX)
    s = _all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), row,
                    "psum_lse")
    return m + torch.log(s)


def _psum_select(logits: torch.Tensor, idx: torch.Tensor, off: int, row):
    """The selected GLOBAL id's logit, summed from its owning rank."""
    owned, lic = _owned(idx, off, logits.shape[-1])
    val = torch.gather(logits, -1, lic[..., None])[..., 0]
    return _all_reduce(torch.where(owned, val, torch.zeros_like(val)),
                       row, "psum_select")


def _validate(cell, mesh, axis: str) -> tuple[int, int]:
    if axis not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {mesh.axis_names!r} have no {axis!r} axis — build "
            f"one with train.mesh.make_mesh(mp_devices=...)")
    V = cell.out_proj.weight.shape[0]
    mp = mesh.shape[axis]
    if V % mp:
        raise ValueError(f"vocab {V} does not divide over mp={mp} shards")
    return V, mp


def _shard(cell, mesh, axis: str, weights):
    """-> (the row, this rank's vocab offset, the shard's weights)."""
    row = _row(mesh)
    if row.world > 1 and row.group is None:
        raise ValueError(
            f"the {row.world}-rank {axis!r} row has no process group: the "
            "sharded decode's merges run over one (multihost.initialize)")
    w = weights if weights is not None else shard_weights(
        stride_weights(cell), row.rank, row.world)
    return row, row.rank * w.bo.shape[0], w


# ---- stride ------------------------------------------------------------------


def _stride_body(cell, w, carry, token, finished, memory, memory_proj,
                 memory_mask, noise, t0: int, *, steps: int,
                 temperature: float, min_len: int, row, off: int):
    """A rank's stride: S chained kernel-2 steps on its slice with the
    driving loop's selection semantics (the JAX ``_reference_stride``),
    the selection merged across the row."""
    dtype = carry[0][0].dtype
    state = stack_carry(carry)
    finished = finished.bool()
    toks, lps = [], []
    for s in range(steps):
        emb = _psum_embed(w.embt, token, off, row)
        logits = fused_decode_step_(cell, state, token, memory, memory_proj,
                                    memory_mask, dtype, emb=emb, weights=w)
        _set_owned(logits, PAD_ID, off, NEG)
        _set_owned(logits, BOS_ID, off, NEG)
        if min_len > 0 and t0 + s < min_len:
            _set_owned(logits, EOS_ID, off, NEG)
        g_nxt = _merge_argmax(logits[0], off, row)
        s_nxt = _merge_argmax(logits[1:] / temperature + noise[s], off, row)
        nxt = torch.cat([g_nxt[None], s_nxt], dim=0)
        lp = _psum_select(logits, nxt, off, row) - _merge_lse(logits, row)
        nxt = torch.where(finished, torch.full_like(nxt, PAD_ID), nxt)
        lp = torch.where(finished, torch.zeros_like(lp), lp)
        finished = finished | (nxt == EOS_ID)
        toks.append(nxt)
        lps.append(lp)
        token = nxt
    return unstack_carry(state, dtype), torch.stack(toks), torch.stack(lps)


def mp_decode_stride(cell, carry, token, finished, memory, memory_proj,
                     memory_mask, noise, t0=0, *, mesh, steps: int,
                     temperature: float = 1.0, min_len: int = 0,
                     axis: str = "mp", weights: StrideWeights | None = None):
    """Vocab-sharded ``fused_decode_stride``: the same ``(new_carry, tokens
    [S, G, B] int32, logprobs [S, G, B])`` outputs on every rank of the
    row, the output head and embedding sharded over ``mesh``'s ``axis``.
    ``noise`` is the full ``[S, K, B, V]``; ``weights`` this rank's
    :func:`shard_weights` (packed here when None). Tokens are bit-exact
    against the replicated stride; logprobs sit within a few f32 ulps
    (module docstring). The carry is not frozen on finished rows, as in
    the JAX ``_reference_stride``."""
    V, _ = _validate(cell, mesh, axis)
    if noise.shape[-1] != V:
        raise ValueError(f"noise vocab dim {noise.shape[-1]} != vocab {V}")
    row, off, w = _shard(cell, mesh, axis, weights)
    noise = noise[..., off:off + w.bo.shape[0]]
    return _stride_body(cell, w, carry, token, finished, memory,
                        memory_proj, memory_mask, noise, int(t0),
                        steps=steps, temperature=temperature,
                        min_len=min_len, row=row, off=off)


# ---- beam --------------------------------------------------------------------


def _merge_topw(pool_s: torch.Tensor, pool_f: torch.Tensor, W: int):
    """Top-W over candidate pools ``[B, N]`` in the replicated order: a
    strictly greater score wins, equal scores go to the lower GLOBAL flat
    id. Flat ids are unique a row, so removing the selected id by value
    is exact -> (scores [B, W], flat ids [B, W] int32)."""
    fmax = torch.iinfo(torch.int32).max
    alive = torch.ones_like(pool_s, dtype=torch.bool)
    outs, outf = [], []
    for _ in range(W):
        s_eff = torch.where(alive, pool_s,
                            torch.full_like(pool_s, -torch.inf))
        m = s_eff.max(dim=-1).values
        is_m = alive & (s_eff == m[:, None])
        fsel = torch.where(is_m, pool_f,
                           torch.full_like(pool_f, fmax)).min(dim=-1).values
        outs.append(m)
        outf.append(fsel)
        alive = alive & (pool_f != fsel[:, None])
    return torch.stack(outs, dim=1), torch.stack(outf, dim=1).to(torch.int32)


def _beam_body(cell, w, state, token, finished, scores, memory, memory_proj,
               memory_mask, dtype, *, t: int, min_len: int, row, off: int,
               V: int, W: int):
    """A rank's beam step: kernel 2 on its slice, its top W in the
    rebased global flat namespace, then the merge across the row."""
    vs = w.bo.shape[0]
    B = token.shape[1]
    emb = _psum_embed(w.embt, token, off, row)
    logits = fused_decode_step_(cell, state, token, memory, memory_proj,
                                memory_mask, dtype, emb=emb, weights=w)
    _set_owned(logits, PAD_ID, off, NEG)
    _set_owned(logits, BOS_ID, off, NEG)
    if min_len > 0 and t < min_len:
        _set_owned(logits, EOS_ID, off, NEG)
    logp = (logits - _merge_lse(logits, row)[..., None]).transpose(0, 1)
    # the PAD continuation row, restricted to the columns this rank owns
    pad_row = _set_owned(torch.full((vs,), NEG, device=logits.device),
                         PAD_ID, off, 0.0)
    cont = torch.where(finished.T.bool()[:, :, None], pad_row, logp)
    total = scores.T.float()[:, :, None] + cont                 # [B, W, V_s]
    ts, fl = top_w(total.reshape(B, W * vs), W)
    # local flat w * V_s + v -> the replicated kernel's w * V + off + v
    gf = ((fl // vs) * V + off + fl % vs).to(torch.int32)
    pool_s = _all_gather(ts.contiguous(), row).permute(1, 0, 2)
    pool_f = _all_gather(gf.contiguous(), row).permute(1, 0, 2)
    return _merge_topw(pool_s.reshape(B, -1), pool_f.reshape(B, -1), W)


def mp_beam_step(cell, carry, token, finished, scores, memory, memory_proj,
                 memory_mask, *, mesh, t: int, min_len: int = 0,
                 axis: str = "mp", weights: StrideWeights | None = None):
    """Vocab-sharded ``fused_beam_step``: the same ``(new_carry, top_scores
    [B, W], top_flat [B, W])`` on every rank of the row, ``flat = lane * V
    + token`` in the replicated kernel's namespace, candidate for
    candidate and in its tie order (module docstring)."""
    V, mp = _validate(cell, mesh, axis)
    W, _B = token.shape
    if W > V // mp:
        raise ValueError(
            f"beam width {W} > per-shard vocab {V // mp}: every shard must "
            f"fill a full local top-{W} candidate list")
    row, off, w = _shard(cell, mesh, axis, weights)
    dtype = carry[0][0].dtype
    state = stack_carry(carry)
    top = _beam_body(cell, w, state, token, finished, scores, memory,
                     memory_proj, memory_mask, dtype, t=int(t),
                     min_len=min_len, row=row, off=off, V=V, W=W)
    return (unstack_carry(state, dtype),) + top
