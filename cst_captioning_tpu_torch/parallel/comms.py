"""Gradient communication: bucketed, bf16-on-the-wire and overlapped
all-reduce (the JAX package's ``parallel/comms.py``).

The gradient all-reduce goes through one entry point, a
:class:`GradReducer` that a step factory builds once (:func:`reduce_tree`
is one reduction through a fresh one), behind the ``train.comm_*`` knobs:

- **Bucketing** (``comm_bucket_mb``): the gradient leaves, ordered by
  parameter family (``train/mesh.py`` ``PARAM_PARTITION_RULES`` order),
  pack into size-targeted buckets; each bucket is one contiguous buffer
  and one ``all_reduce``. The sum is elementwise, so at two ranks bucketed
  f32 is bitwise equal to one all-reduce a leaf.
- **bf16 on the wire** (``comm_dtype="bf16"``): the buffers cast to
  bfloat16 before the collective and back after, half the bytes; the
  parameters and Adam moments stay float32.
- **Overlap** (``comm_overlap``, with ``rl.update_chunks``): each chunk's
  buckets start (``async_op=True``) while the next chunk's backward runs
  (``rl/scst._chunked_loss_grads``); ``"eager"`` waits at once and is the
  bitwise reference of ``"defer"``.

The leaves are the JAX parameter tree's (``mesh.param_leaves``: each a
contiguous block of a port tensor), so a model's bucket plan equals the
JAX package's leaf for leaf and byte for byte. The plan is built on the
host from shapes and dtypes, once a reducer, and the ``comm.*`` gauges are
set at its first reduction.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
import torch.distributed as dist

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.train.mesh import (
    MP_PARAM_PARTITION_RULES,
    PARAM_PARTITION_RULES,
    Leaf,
)

_WIRE_DTYPES = ("f32", "bf16")
_OVERLAP_MODES = ("off", "defer", "eager")
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64"}
_NAMED_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}

# bytes-on-wire histogram buckets: 64 KiB .. 64 MiB per message
_BUCKET_BYTES_BUCKETS = tuple(float(1 << s) for s in range(16, 27))


@dataclass(frozen=True)
class CommConfig:
    """How the steps reduce gradients across the ranks.

    ``bucket_mb``: target payload per collective in MiB of wire bytes (0:
    one all-reduce a leaf, still in the wire dtype). ``dtype``: "f32" or
    "bf16". ``overlap``: "off" | "defer" | "eager" (only the chunked RL
    update reads it)."""

    bucket_mb: float = 4.0
    dtype: str = "f32"
    overlap: str = "off"

    def __post_init__(self):
        if self.dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"unknown comm dtype {self.dtype!r} "
                f"(expected one of {_WIRE_DTYPES})")
        if self.overlap not in _OVERLAP_MODES:
            raise ValueError(
                f"unknown comm overlap mode {self.overlap!r} "
                f"(expected one of {_OVERLAP_MODES})")
        if self.bucket_mb < 0:
            raise ValueError(f"comm bucket_mb {self.bucket_mb} must be >= 0")

    @classmethod
    def from_train(cls, train) -> "CommConfig":
        """From a ``TrainConfig``'s ``comm_*`` knobs."""
        return cls(bucket_mb=train.comm_bucket_mb, dtype=train.comm_dtype,
                   overlap="defer" if train.comm_overlap else "off")


@dataclass(frozen=True)
class Bucket:
    indices: tuple[int, ...]      # leaf indices (family-ordered)
    wire_dtype: str               # dtype name on the wire
    bytes_on_wire: int            # payload bytes of ONE all-reduce


@dataclass(frozen=True)
class BucketPlan:
    buckets: tuple[Bucket, ...]
    n_leaves: int
    bytes_on_wire: int            # total payload bytes a reduction


def _family_rank(path: str) -> int:
    """A path's family position in PARAM_PARTITION_RULES; paths no rule
    matches sort last (stably)."""
    for rank, (_, pattern, _spec) in enumerate(PARAM_PARTITION_RULES):
        if re.fullmatch(pattern, path):
            return rank
    return len(PARAM_PARTITION_RULES)


def _mp_sharded(path: str) -> bool:
    """Whether MP_PARAM_PARTITION_RULES puts this path on the 'mp' axis."""
    for _family, pattern, spec in MP_PARAM_PARTITION_RULES:
        if re.fullmatch(pattern, path):
            return any(a == "mp" for a in spec if a is not None)
    return False


def mp_shard_view(leaves: list[Leaf], mp_devices: int) -> list[Leaf]:
    """The data-parallel payload under 'mp' sharding: every mp-sharded leaf
    carries ceil(1/mp) of its elements a device (flat). Identity at
    ``mp_devices <= 1``."""
    if mp_devices <= 1:
        return leaves
    return [Leaf(lf.path, (-(-lf.numel // mp_devices),), lf.dtype,
                 lf.param, lf.offset) if _mp_sharded(lf.path) else lf
            for lf in leaves]


def _wire_dtype(leaf: Leaf, comm: CommConfig) -> torch.dtype:
    if comm.dtype == "bf16" and leaf.dtype.is_floating_point:
        return torch.bfloat16
    return leaf.dtype


def plan_buckets(leaves: list[Leaf], comm: CommConfig) -> BucketPlan:
    """Family-ordered, size-targeted bucket plan. Leaves sort by (family
    rank, flatten order), then pack greedily into buckets of at most
    ``bucket_mb`` MiB of wire bytes; a leaf larger than the target gets its
    own bucket; only leaves of one wire dtype share a bucket."""
    order = sorted(range(len(leaves)),
                   key=lambda i: (_family_rank(leaves[i].path), i))
    target = int(comm.bucket_mb * (1 << 20))
    buckets: list[Bucket] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_dtype = None

    def flush():
        nonlocal cur, cur_bytes, cur_dtype
        if cur:
            buckets.append(Bucket(indices=tuple(cur), wire_dtype=cur_dtype,
                                  bytes_on_wire=cur_bytes))
        cur, cur_bytes, cur_dtype = [], 0, None

    for i in order:
        wd = _wire_dtype(leaves[i], comm)
        nbytes = leaves[i].numel * wd.itemsize
        name = _DTYPE_NAMES[wd]
        same = cur_dtype is None or name == cur_dtype
        fits = target <= 0 or not cur or cur_bytes + nbytes <= target
        if not (same and fits):
            flush()
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = name
        if target <= 0:
            flush()  # bucket_mb=0: one message a leaf
    flush()
    return BucketPlan(buckets=tuple(buckets), n_leaves=len(leaves),
                      bytes_on_wire=sum(b.bytes_on_wire for b in buckets))


def per_leaf_f32_bytes(leaves: list[Leaf]) -> int:
    """Bytes on the wire of one f32 all-reduce a leaf."""
    return sum(lf.numel * 4 for lf in leaves)


def _observe_plan(plan: BucketPlan) -> None:
    """The reduction's shape as the ``comm.buckets`` /
    ``comm.bytes_on_wire`` gauges and the ``comm.bucket_bytes``
    histogram, from host values."""
    obs.gauge("comm.buckets").set(float(len(plan.buckets)))
    obs.gauge("comm.bytes_on_wire").set(float(plan.bytes_on_wire))
    hist = obs.histogram("comm.bucket_bytes", _BUCKET_BYTES_BUCKETS)
    for b in plan.buckets:
        hist.observe(float(b.bytes_on_wire))


def _all_reduce(t: torch.Tensor, mesh, async_op: bool = False):
    """Sum ``t`` in place over the mesh's ranks -> the work handle (async)
    or None. Without a process group (world 1) there is nothing to sum."""
    if mesh.group is None:
        return None
    return dist.all_reduce(t, group=mesh.group, async_op=async_op)


# the model-parallel row's broadcasts (broadcast_row) since
# reset_row_counts(): calls and bytes a rank
ROW_COUNTS: dict[str, int] = {}


def reset_row_counts() -> None:
    ROW_COUNTS.clear()


def broadcast_row(tensors, row) -> list[torch.Tensor]:
    """The ``'mp'`` row's first rank's ``tensors`` on every rank of the
    row, in one flat float32 broadcast -> new tensors in their own dtypes
    (the inputs when the row is one rank). A row's ranks compute the same
    rows; the broadcast keeps them bitwise equal where a backward kernel
    is not deterministic (a JAX device mesh replicates exactly)."""
    if row is None or row.world == 1 or row.group is None:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ROW_COUNTS["broadcasts"] = ROW_COUNTS.get("broadcasts", 0) + 1
    ROW_COUNTS["bytes"] = ROW_COUNTS.get("bytes", 0) + flat.numel() * 4
    dist.broadcast(flat, src=row.global_ranks[0], group=row.group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def reduce_sums(num: torch.Tensor, den: torch.Tensor, mesh):
    """A loss's sum form ``(num, den)`` summed over the ranks, in one
    all-reduce -> (num, den) float32 tensors."""
    sums = torch.stack([num.detach().float(), den.detach().float()])
    _all_reduce(sums, mesh)
    return sums[0], sums[1]


class Reduction:
    """An all-reduce of a gradient list in flight: :meth:`wait` -> the
    reduced gradients, each in its own dtype."""

    def __init__(self, out, views, pending):
        self._out = out
        self._views = views
        self._pending = pending   # (work or None, buffer, leaf indices)

    def wait(self) -> list[torch.Tensor]:
        for work, buf, indices in self._pending:
            if work is not None:
                work.wait()
            if indices is None:
                continue          # reduced in place
            off = 0
            for i in indices:
                v = self._views[i]
                v.copy_(buf[off:off + v.numel()])
                off += v.numel()
        self._pending = []
        return self._out


class GradReducer:
    """The gradient all-reduce of one leaf layout under one
    :class:`CommConfig`, as a step factory holds it: the bucket plan is
    built once, from the leaves' shapes and dtypes, and its ``comm.*``
    gauges are set at the first reduction (the JAX package observes the
    plan once, when it traces the step). ``leaves`` locate the JAX tree's
    leaves in the gradient list (``mesh.param_leaves``) and must cover
    every element. ``comm=None``: one all-reduce a leaf, no cast.
    Otherwise each bucket of :func:`plan_buckets` is one contiguous buffer
    in the wire dtype, reduced once and split back."""

    def __init__(self, leaves: list[Leaf], mesh, comm: CommConfig | None):
        self.leaves = leaves
        self.mesh = mesh
        self.plan = None if comm is None else plan_buckets(leaves, comm)
        self._observed = False

    def start(self, grads, async_op: bool = True) -> Reduction:
        """Start the all-reduce of ``grads`` (a list of tensors) -> a
        :class:`Reduction`; ``grads`` are left as they were."""
        out = [g.detach().clone().contiguous() for g in grads]
        flat = [o.view(-1) for o in out]
        views = [flat[lf.param][lf.offset:lf.offset + lf.numel]
                 for lf in self.leaves]
        pending = []
        if self.plan is None:
            for v in views:
                pending.append((_all_reduce(v, self.mesh, async_op), v, None))
            return Reduction(out, views, pending)
        if not self._observed:
            _observe_plan(self.plan)
            self._observed = True
        for bucket in self.plan.buckets:
            wd = _NAMED_DTYPES[bucket.wire_dtype]
            buf = torch.cat([views[i].to(wd) for i in bucket.indices])
            pending.append((_all_reduce(buf, self.mesh, async_op), buf,
                            bucket.indices))
        return Reduction(out, views, pending)

    def __call__(self, grads) -> list[torch.Tensor]:
        """All-reduce ``grads`` and wait -> new tensors."""
        return self.start(grads, async_op=False).wait()


def _default_leaves(grads) -> list[Leaf]:
    return [Leaf(str(i), tuple(g.shape), g.dtype, i, 0)
            for i, g in enumerate(grads)]


def start_reduce(grads, mesh, comm: CommConfig | None,
                 leaves: list[Leaf] | None = None,
                 async_op: bool = True) -> Reduction:
    """One reduction through a fresh :class:`GradReducer` (its plan built
    and observed for this call); ``leaves`` default to one a tensor."""
    return GradReducer(leaves or _default_leaves(grads), mesh,
                       comm).start(grads, async_op)


def reduce_tree(grads, mesh, comm: CommConfig | None,
                leaves: list[Leaf] | None = None) -> list[torch.Tensor]:
    """All-reduce a gradient list over the mesh (:func:`start_reduce`,
    waited for) -> new tensors; ``grads`` are left as they were."""
    return start_reduce(grads, mesh, comm, leaves, async_op=False).wait()


def ledger(leaves: list[Leaf], comm: CommConfig | None,
           reductions: int = 1, mp_devices: int = 1) -> dict:
    """Bytes-on-wire accounting of one update that reduces a payload of
    ``leaves`` ``reductions`` times (chunks + 1 for the overlapped chunked
    update); ``mp_devices > 1`` counts each mp-sharded leaf's 1/mp block."""
    leaves = mp_shard_view(leaves, mp_devices)
    if comm is None:
        n = len(leaves)
        return {"buckets": n, "messages_per_update": n * reductions,
                "bytes_on_wire_per_update":
                    per_leaf_f32_bytes(leaves) * reductions}
    plan = plan_buckets(leaves, comm)
    return {"buckets": len(plan.buckets),
            "messages_per_update": len(plan.buckets) * reductions,
            "bytes_on_wire_per_update": plan.bytes_on_wire * reductions}
