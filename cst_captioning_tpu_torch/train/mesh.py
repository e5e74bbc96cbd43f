"""The data mesh and the parameter partition contract (the JAX package's
``train/mesh.py``).

A JAX ``Mesh`` with one ``'data'`` axis of N devices is, in the port, N
ranks of a ``torch.distributed`` group, one process a device:
:func:`make_mesh` returns a :class:`DataMesh` that names the axis, this
rank, the world size, this rank's device and the process groups. Batches
shard along axis 0 across the ranks (:func:`shard_batch`: this rank's
contiguous rows, the ``Batcher(host_shard=...)`` slicing); parameters and
optimizer state are replicated, and :func:`replicate` broadcasts them from
rank 0. :func:`submesh` is a ``DataMesh`` over a subset of the ranks
(the actor and learner sides of ``parallel/submesh.py``), with its own
group.

``make_mesh(seq_devices=S)`` gives the ``('data', 'seq')`` grid of
sequence parallelism and ``make_mesh(mp_devices=M)`` the ``('data',
'mp')`` grid of model parallelism, each a :class:`GridMesh`: global rank
``r`` is cell ``(r // S, r % S)`` (the JAX mesh's ``devices.reshape(n //
S, S)``), its ``.data`` a ``DataMesh`` over this rank's column (the ranks
of its second coordinate; the batch axis) and its ``.row`` one over its
row (the ranks of its data coordinate), named by the second axis:
``.seq`` (the frame axis) or ``.mp`` (the decode's vocabulary,
``ops/decode_mp.py``). :func:`batch_sharding` is then the data
coordinate: every rank of a row collates the same rows. As in the JAX
package, a grid is sequence parallel when ``'seq'`` is among its axis
names (:func:`is_seq_grid`) and model parallel when ``'mp'`` is
(:func:`mp_row`).

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


@dataclass(frozen=True)
class DataMesh:
    """One ``'data'`` axis over ``world`` ranks, seen from ``rank``
    (its index on the axis). ``ranks`` are the axis's global ranks (empty:
    ``0 .. world-1``). A mesh without a ``group`` and ``world`` above 1
    runs in one process: a plan over virtual ranks (``AsyncSCSTTrainer``
    runs every role of such a plan here)."""

    axis: str
    rank: int
    world: int
    device: torch.device
    group: object = None        # the axis's process group (None: world 1)
    ranks: tuple = ()

    @property
    def global_ranks(self) -> tuple[int, ...]:
        return tuple(self.ranks) or tuple(range(self.world))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.world}

    def __deepcopy__(self, memo):
        # a mesh names ranks and a live group: a copied model (a
        # TrainState clone) shares it
        return self


@dataclass(frozen=True)
class GridMesh:
    """A ``('data', <second>)`` grid over ``world`` ranks, seen from
    global rank ``rank`` = ``data.rank * row.world + row.rank``: ``data``
    is the column through this rank (the batch axis, over the ranks of its
    second coordinate), ``row`` the row (over the ranks of its data
    coordinate), whose axis names the grid's kind: ``'seq'`` (sequence
    parallel, :attr:`seq`) or ``'mp'`` (model parallel, :attr:`mp`).
    ``group`` is the whole grid's."""

    rank: int
    world: int
    device: torch.device
    data: DataMesh
    row: DataMesh
    group: object = None

    @property
    def global_ranks(self) -> tuple[int, ...]:
        return tuple(range(self.world))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.data.axis, self.row.axis)

    @property
    def shape(self) -> dict[str, int]:
        return {self.data.axis: self.data.world, self.row.axis: self.row.world}

    def _named(self, axis: str) -> DataMesh:
        if self.row.axis != axis:
            raise AttributeError(
                f"a {self.axis_names!r} grid has no {axis!r} axis")
        return self.row

    @property
    def seq(self) -> DataMesh:
        """The row of a sequence-parallel grid (AttributeError else)."""
        return self._named("seq")

    @property
    def mp(self) -> DataMesh:
        """The row of a model-parallel grid (AttributeError else)."""
        return self._named("mp")

    def __deepcopy__(self, memo):
        return self


def grid_cell(rank: int, row_devices: int) -> tuple[int, int]:
    """Global rank -> its (data, second-axis) coordinates on the grid."""
    return rank // row_devices, rank % row_devices


def _grid(rank: int, world: int, row_devices: int, axis: str,
          row_axis: str, dev: torch.device) -> GridMesh:
    """The grid over ``world`` ranks with ``row_devices`` ranks a row on
    axis ``row_axis``. Every rank creates every column's group and then
    every row's, in one order (``multihost.group_of`` is collective over
    the world)."""
    S, n = row_devices, world // row_devices
    grouped = dist.is_initialized()
    cols = [tuple(d * S + s for d in range(n)) for s in range(S)]
    rows = [tuple(d * S + s for s in range(S)) for d in range(n)]
    groups = {}
    for ranks in cols + rows:
        groups[ranks] = (multihost.group_of(ranks)
                         if grouped and len(ranks) > 1 else None)
    d, s = grid_cell(rank, S)
    col, row = cols[s], rows[d]
    return GridMesh(
        rank=rank, world=world, device=dev,
        data=DataMesh(axis=axis, rank=d, world=n, device=dev,
                      group=groups[col], ranks=col),
        row=DataMesh(axis=row_axis, rank=s, world=S, device=dev,
                     group=groups[row], ranks=row),
        group=dist.group.WORLD if grouped else None)


def is_seq_grid(mesh) -> bool:
    """Whether ``mesh`` is sequence parallel: ``'seq'`` among its axis
    names (the JAX trainer's test)."""
    return mesh is not None and "seq" in mesh.axis_names


def mp_row(mesh) -> DataMesh | None:
    """The ``'mp'`` row of a model-parallel grid, else None."""
    if isinstance(mesh, GridMesh) and mesh.row.axis == "mp":
        return mesh.row
    return None


def make_mesh(num_devices: int = 0, axis: str = "data",
              seq_devices: int = 1, mp_devices: int = 1,
              device=None, seq_axis: str = "seq"):
    """The mesh over the initialized process group (world 1 without one):
    the 1-D ``(data,)`` :class:`DataMesh`, or with ``seq_devices > 1`` the
    ``('data', 'seq')`` and with ``mp_devices > 1`` the ``('data', 'mp')``
    :class:`GridMesh` (either must divide the world; they do not compose).
    ``num_devices`` 0 takes the world size; N > 1 must equal it.
    ``device`` is this rank's (default ``cuda:<LOCAL_RANK>``)."""
    if seq_devices > 1 and mp_devices > 1:
        raise ValueError(
            "seq_devices > 1 and mp_devices > 1 cannot compose yet: the "
            "collective attention softmax and the sharded-vocab decode "
            "assume different second axes (pick one)")
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
    for n, name, row_axis in ((seq_devices, "seq_devices", seq_axis),
                              (mp_devices, "mp_devices", "mp")):
        if n > 1:
            if world % n:
                raise ValueError(
                    f"{name} {n} must divide the {world} mesh devices")
            return _grid(rank, world, n, axis, row_axis, dev)
    return DataMesh(axis=axis, rank=rank, world=world, device=dev,
                    group=dist.group.WORLD if dist.is_initialized() else None,
                    ranks=tuple(range(world)))


def submesh(mesh: DataMesh, ranks) -> DataMesh | None:
    """The ``DataMesh`` over ``ranks`` (global ranks of ``mesh``, in axis
    order), seen from this rank: its ``rank`` and ``world`` are the index
    and size within ``ranks``, its ``group`` their own
    (``multihost.group_of``; none for one rank, or when ``mesh`` has no
    group). A rank outside ``ranks`` gets None, never a mesh it could
    enter a collective on. Creating the group is collective over the whole
    world: every rank calls this for each rank set, in the same order."""
    ranks = tuple(int(r) for r in ranks)
    parent = mesh.global_ranks
    if not ranks or len(set(ranks)) != len(ranks) \
            or not set(ranks) <= set(parent):
        raise ValueError(f"submesh ranks {ranks} are not distinct ranks of "
                         f"the mesh's {parent}")
    group = (multihost.group_of(ranks)
             if len(ranks) > 1 and mesh.group is not None else None)
    me = parent[mesh.rank]
    if me not in ranks:
        return None
    return DataMesh(axis=mesh.axis, rank=ranks.index(me), world=len(ranks),
                    device=mesh.device, group=group, ranks=ranks)


def data_axis(mesh):
    """The mesh's batch axis: a ``DataMesh`` itself, a grid's column."""
    return mesh.data if isinstance(mesh, GridMesh) else mesh


def batch_sharding(mesh) -> tuple[int, int]:
    """This rank's share of a batch's axis 0, the ``Batcher``
    ``host_shard`` argument: ``(rank, world)`` on a ``DataMesh``, the
    data coordinate and the column's width on a grid (every rank of a row
    takes the same rows)."""
    d = data_axis(mesh)
    return d.rank, d.world


def shard_batch(mesh, batch, dim: int = 0):
    """A global batch pytree -> this rank's contiguous rows along ``dim``,
    as ``Batcher(host_shard=(rank, world))`` slices them (on a grid, by
    the data coordinate)."""
    mesh = data_axis(mesh)

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


def replicate(mesh: DataMesh, state, src: int = 0):
    """Broadcast a ``TrainState``'s parameters, optimizer moments and step
    from global rank ``src`` -> the state (updated in place). The JAX
    package assembles its replicated arrays from identical host copies; a
    broadcast also keeps a rank that restored another file from drifting
    apart."""
    if mesh.group is None or mesh.world == 1:
        return state
    tensors = [p.data for p in state.params]
    for k in sorted(state.opt_state):
        v = state.opt_state[k]
        if isinstance(v, list):
            tensors.extend(v)
    for t in tensors:
        dist.broadcast(t, src=src, group=mesh.group)
    counters = torch.tensor([state.step, state.opt_state.get("count", 0),
                             state.seed], dtype=torch.int64,
                            device=tensors[0].device)
    dist.broadcast(counters, src=src, group=mesh.group)
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
