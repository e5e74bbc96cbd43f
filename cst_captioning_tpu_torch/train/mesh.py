"""The data mesh and the parameter partition contract (the JAX package's
``train/mesh.py``).

A JAX ``Mesh`` with one ``'data'`` axis of N devices is, in the port, N
ranks of a ``torch.distributed`` group, one process a device:
:func:`make_mesh` returns a :class:`DataMesh` that names the axis, this
rank, the world size, this rank's device and the process groups. Batches
shard along axis 0 across the ranks (:func:`shard_batch`: this rank's
contiguous rows, the ``Batcher(host_shard=...)`` slicing); parameters and
optimizer state are replicated, and :func:`replicate` broadcasts them from
rank 0. The ``('data', 'seq')`` and ``('data', 'mp')`` meshes come with
the model- and sequence-parallel slice and raise.

The partition rule tables are the JAX package's, as plain data: ordered
``(family, path regex, spec)`` rows, the spec a tuple of axis names or
``None`` (JAX's ``PartitionSpec``), matched first-wins over the ``/``-joined
paths of the JAX parameter tree. :func:`param_path_names` gives those
paths for the port's model (``convert.py``'s layout, in JAX flatten
order), and :func:`param_leaves` where each lies in the port's tensors,
which is what the gradient buckets (``parallel/comms.py``) are planned on.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from cst_captioning_tpu_torch.models.decoder import LSTM_GATE_ORDER
from cst_captioning_tpu_torch.train import multihost

_MODEL_SEQUENCE = "the model- and sequence-parallel slice"


@dataclass(frozen=True)
class DataMesh:
    """One ``'data'`` axis over ``world`` ranks, seen from ``rank``."""

    axis: str
    rank: int
    world: int
    device: torch.device
    group: object = None        # the axis's process group (None: world 1)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.world}


def make_mesh(num_devices: int = 0, axis: str = "data",
              seq_devices: int = 1, mp_devices: int = 1,
              device=None) -> DataMesh:
    """The 1-D ``(data,)`` mesh over the initialized process group (world
    1 without one). ``num_devices`` 0 takes the world size; N > 1 must
    equal it. ``device`` is this rank's (default ``cuda:<LOCAL_RANK>``)."""
    if seq_devices > 1 and mp_devices > 1:
        raise ValueError(
            "seq_devices > 1 and mp_devices > 1 cannot compose yet: the "
            "collective attention softmax and the sharded-vocab decode "
            "assume different second axes (pick one)")
    if seq_devices > 1 or mp_devices > 1:
        raise ValueError(
            f"seq_devices={seq_devices}, mp_devices={mp_devices}: the "
            "('data', 'seq') and ('data', 'mp') meshes are not ported yet "
            f"({_MODEL_SEQUENCE})")
    rank, world = multihost.host_shard()
    if num_devices and num_devices != world:
        raise ValueError(
            f"mesh.num_devices={num_devices} but this run has {world} "
            f"process(es): launch {num_devices} processes, one a device "
            f"(python -m torch.distributed.run --standalone "
            f"--nproc-per-node {num_devices} -m "
            "cst_captioning_tpu_torch.cli.train ...), or leave "
            "mesh.num_devices at 0")
    dev = multihost.local_device(torch.device("cuda" if device is None
                                              else device))
    return DataMesh(axis=axis, rank=rank, world=world, device=dev,
                    group=dist.group.WORLD if dist.is_initialized() else None)


def batch_sharding(mesh: DataMesh) -> tuple[int, int]:
    """This rank's share of a batch's axis 0: ``(rank, world)``, the
    ``Batcher`` ``host_shard`` argument."""
    return mesh.rank, mesh.world


def shard_batch(mesh: DataMesh, batch, dim: int = 0):
    """A global batch pytree -> this rank's contiguous rows along ``dim``,
    as ``Batcher(host_shard=(rank, world))`` slices them."""

    def take(x):
        n = x.shape[dim]
        if n % mesh.world:
            raise ValueError(
                f"batch axis of {n} rows does not divide over the "
                f"{mesh.world}-rank '{mesh.axis}' axis")
        lb = n // mesh.world
        if isinstance(x, torch.Tensor):
            return x.narrow(dim, mesh.rank * lb, lb)
        return np.take(np.asarray(x), range(mesh.rank * lb,
                                            (mesh.rank + 1) * lb), axis=dim)

    return multihost._tree_map(take, batch)


def replicate(mesh: DataMesh, state):
    """Broadcast a ``TrainState``'s parameters, optimizer moments and step
    from rank 0 -> the state (updated in place). The JAX package assembles
    its replicated arrays from identical host copies; a broadcast also
    keeps a rank that restored another file from drifting apart."""
    if mesh.group is None or mesh.world == 1:
        return state
    tensors = [p.data for p in state.params]
    for k in sorted(state.opt_state):
        v = state.opt_state[k]
        if isinstance(v, list):
            tensors.extend(v)
    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)
    counters = torch.tensor([state.step, state.opt_state.get("count", 0),
                             state.seed], dtype=torch.int64,
                            device=tensors[0].device)
    dist.broadcast(counters, src=0, group=mesh.group)
    state.step, count, state.seed = (int(v) for v in counters.tolist())
    if "count" in state.opt_state:
        state.opt_state["count"] = count
    return state


# ---- the parameter partition contract ----------------------------------------
#
# Ordered (family, path regex, spec) tables, first match wins, as the JAX
# package's: PARAM_PARTITION_RULES is the data-parallel table (every
# family replicated), MP_PARAM_PARTITION_RULES the flagship-XL
# model-parallel one (the vocab families and the LSTM gate matrices over
# 'mp'). A spec is a tuple of axis names or None, like a PartitionSpec.
PARAM_PARTITION_RULES: tuple[tuple[str, str, tuple], ...] = (
    ("encoder_embed", r"params/encoder/embed_[^/]+/.*", ()),
    ("carry_init", r"params/init_[hc]\d+/.*", ()),
    ("decoder_attention", r"params/cell/attention/.*", ()),
    ("decoder_lstm", r"params/cell/lstm\d+/.*", ()),
    ("word_embed", r"params/cell/word_embed/.*", ()),
    ("output_head", r"params/cell/out_proj/.*", ()),
)

MP_PARAM_PARTITION_RULES: tuple[tuple[str, str, tuple], ...] = (
    ("encoder_embed", r"params/encoder/embed_[^/]+/.*", ()),
    ("carry_init", r"params/init_[hc]\d+/.*", ()),
    ("decoder_attention", r"params/cell/attention/.*", ()),
    ("decoder_lstm_gate_kernel", r"params/cell/lstm\d+/[ih][ifgo]/kernel",
     (None, "mp")),
    ("decoder_lstm_gate_bias", r"params/cell/lstm\d+/h[ifgo]/bias", ("mp",)),
    ("word_embed", r"params/cell/word_embed/embedding", ("mp",)),
    ("output_head_kernel", r"params/cell/out_proj/kernel", (None, "mp")),
    ("output_head_bias", r"params/cell/out_proj/bias", ("mp",)),
)

# the JAX package's repo-root-relative dump of the parameter tree the rules
# were written against
SHARDING_CONTRACT = "scripts/shardings_contract.json"


@dataclass(frozen=True)
class Leaf:
    """One leaf of the JAX parameter tree, located in the port's tensors:
    ``numel`` elements from ``offset`` of the flattened tensor ``param``
    (an index into the gradient list), shaped ``shape`` in the JAX tree.
    Every JAX leaf is a contiguous block of rows of a port tensor."""

    path: str
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    param: int = 0
    offset: int = 0

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


def _flatten(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict in JAX flatten order (sorted
    keys), paths ``/``-joined."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> tuple[list[Leaf], list]:
    """A nested dict of tensors or arrays -> (its leaves in JAX flatten
    order, each a whole tensor, and the values in that order)."""
    pairs = list(_flatten(tree))
    leaves = [Leaf(p, tuple(v.shape), _torch_dtype(v.dtype), i)
              for i, (p, v) in enumerate(pairs)]
    return leaves, [v for _, v in pairs]


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64}


def _torch_dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else _DTYPES[str(dt)]


def param_leaves(model: torch.nn.Module) -> list[Leaf]:
    """The JAX parameter tree's leaves of a ``CaptionModel``, in JAX
    flatten order, each located in ``model.parameters()``
    (``convert.py``'s mapping: a dense kernel is its weight's transpose,
    an LSTM gate's kernel and bias are rows ``g*H:(g+1)*H`` of the fused
    weights, the attention score kernel is the score vector)."""
    cfg = model.cfg
    index = {n: i for i, (n, _) in enumerate(model.named_parameters())}
    params = list(model.parameters())

    def leaf(name, shape, row0=0):
        """-> (JAX shape, parameter index, element offset of row0)."""
        t = params[index[name]]
        return tuple(shape), index[name], row0 * (t[0].numel()
                                                   if t.ndim > 1 else 1)

    def dense(prefix, bias=True):
        w = params[index[f"{prefix}.weight"]]
        d = {"kernel": leaf(f"{prefix}.weight", (w.shape[1], w.shape[0]))}
        if bias:
            d["bias"] = leaf(f"{prefix}.bias", (w.shape[0],))
        return d

    H, A = cfg.d_hidden, cfg.d_att
    cell = {
        "word_embed": {"embedding": leaf(
            "cell.word_embed.weight",
            tuple(params[index["cell.word_embed.weight"]].shape))},
        "attention": {
            "mem_proj": dense("cell.attention.mem_proj", bias=False),
            "query_proj": dense("cell.attention.query_proj"),
            "score": {"kernel": leaf("cell.attention.score", (A, 1))},
        },
        "out_proj": dense("cell.out_proj"),
    }
    tree = {"encoder": {f"embed_{n}": dense(f"encoder.embed.{n}")
                        for n, _ in cfg.modalities},
            "cell": cell}
    for layer in range(cfg.num_layers):
        n_in = params[index[f"cell.lstm.{layer}.weight_i"]].shape[1]
        lstm = {}
        for k, g in enumerate(LSTM_GATE_ORDER):
            lstm[f"i{g}"] = {"kernel": leaf(f"cell.lstm.{layer}.weight_i",
                                            (n_in, H), k * H)}
            lstm[f"h{g}"] = {
                "kernel": leaf(f"cell.lstm.{layer}.weight_h", (H, H), k * H),
                "bias": leaf(f"cell.lstm.{layer}.bias", (H,), k * H)}
        cell[f"lstm{layer}"] = lstm
        tree[f"init_c{layer}"] = dense(f"init_c.{layer}")
        tree[f"init_h{layer}"] = dense(f"init_h.{layer}")
    return [Leaf(path, shape, params[i].dtype, i, off)
            for path, (shape, i, off) in _flatten({"params": tree})]


def param_path_names(model: torch.nn.Module) -> list[str]:
    """The ``/``-joined JAX paths of the model's parameters, in JAX
    flatten order (the contract's naming)."""
    return [leaf.path for leaf in param_leaves(model)]


def match_rule(rules, name: str) -> tuple[str, tuple | None]:
    """First (family, spec) whose regex fullmatches ``name``; an unruled
    parameter raises ``ValueError``."""
    for family, pattern, spec in rules:
        if re.fullmatch(pattern, name):
            return family, spec
    raise ValueError(
        f"parameter {name!r} matches no partition rule; add a family rule "
        "for it (scripts/check_shardings.py verifies coverage)")


def match_partition_rules(rules, names) -> list:
    """The spec of each of ``names`` (a model's :func:`param_path_names`),
    first match wins, no match raises."""
    return [match_rule(rules, name)[1] for name in names]


def rule_provenance(rules, param_names) -> dict[str, str]:
    """param path -> the family whose rule claimed it."""
    return {name: match_rule(rules, name)[0] for name in param_names}


def rule_coverage(param_names, rules=None) -> tuple[list[str], list[str]]:
    """-> (families matching no param, params matched by no family)."""
    if rules is None:
        rules = PARAM_PARTITION_RULES
    unmatched = []
    unruled = set(param_names)
    for family, pattern, _ in rules:
        rx = re.compile(pattern)
        hits = [p for p in param_names if rx.fullmatch(p)]
        if not hits:
            unmatched.append(family)
        unruled.difference_update(hits)
    return unmatched, sorted(unruled)


def param_partition_specs(names, rules=None) -> list:
    """The spec of each parameter path (default: the data-parallel table,
    every family replicated)."""
    return match_partition_rules(
        PARAM_PARTITION_RULES if rules is None else rules, names)
