"""Processes and ranks (the JAX package's ``train/multihost.py``).

The JAX package is single-controller: one process drives every device of a
mesh, and ``multihost.py`` adds processes on top. PyTorch's idiom is one
process per device, with ``torch.distributed`` collectives between them, so
here a JAX ``'data'`` axis of N devices is N ranks:

- :func:`initialize` forms the process group from explicit arguments or a
  launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``); with neither, a single-process run is
  left untouched. The backend is ``nccl`` for CUDA and ``gloo`` for the
  CPU unless the caller names one; an init that fails raises, and the
  group's ``timeout`` turns a dead peer into an error, not a hang.
  Host-object collectives run on a ``gloo`` CPU group beside an ``nccl``
  group.
- Input: every rank feeds only its own rows (``Batcher(host_shard=(rank,
  world))``); :func:`put_global` puts them on this rank's device.
- Output: :func:`to_host_local` reads this rank's rows,
  :func:`allgather_to_host` every rank's, and the host-object helpers
  (:func:`allgather_pyobj`, :func:`broadcast_pyobj`,
  :func:`allgather_arrays`, :func:`global_scalar_mean`,
  :func:`global_weighted_mean`) merge host values.
- Groups over a subset of the ranks (:func:`group_of`, the actor and
  learner submeshes of ``parallel/submesh.py``): ``dist.new_group`` is
  collective over the whole world, so every rank creates each group, in
  the same order; they are cached by their rank tuple.
- Generations (elastic training, ``train/trainer.py``): a process keeps
  the rank it was launched with as its host id for its whole life
  (:func:`host_identity`); after a peer loss or a rejoin,
  :func:`regroup` tears the old group down (NCCL's is aborted: it holds a
  dead rank) and forms a new one over the live hosts from a ``FileStore``
  in the shared health directory, its rank the host's index among them.
  A generation of one host forms no group: the survivor runs alone.
- Tensors between role ranks (the decoupled RL split, ``rl/async_scst.py``):
  :func:`post_send` / :func:`post_recv`, a tagged point-to-point transfer
  (staged through host memory on gloo, whose send and recv take CPU
  tensors only; on the device with NCCL), and :func:`broadcast_tensors`
  from one rank to a group, one flat buffer a dtype.

Single-process behaviour is the identity, as in the JAX package. Each
cross-process helper runs inside ``resilience.health.collective_span``
with the JAX span names, so a completed collective refreshes the health
monitor's liveness and a slow one shows as a ``dcn_stall``.
"""

from __future__ import annotations

import datetime
import io
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from cst_captioning_tpu_torch.resilience.health import collective_span

DEFAULT_TIMEOUT_S = 300.0

# the gloo group host objects travel on (the world group when the world
# group is gloo already); set by initialize
_CPU_GROUP = None
# the group timeout of initialize, which the subgroups inherit
_TIMEOUT = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
# subgroups by their sorted global rank tuple (group_of)
_GROUPS: dict[tuple[int, ...], object] = {}
# (host id, hosts): the rank and world this process was launched with,
# kept across regroups (None: the current group's rank and world)
_IDENTITY: tuple[int, int] | None = None
# the backend of the launch, which every later generation uses
_BACKEND = ""


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Form the process group -> whether this run is distributed.

    Explicit arguments win; missing ones come from the launcher's env
    (``RANK``, ``WORLD_SIZE``; ``init_method`` defaults to ``env://``,
    which reads ``MASTER_ADDR`` / ``MASTER_PORT``). With no world size
    from either, a single-process run is untouched (a SLURM or MPI
    allocation of several tasks gets a warning: every task would train
    alone). ``backend`` defaults to ``nccl`` for a CUDA ``device`` and
    ``gloo`` for the CPU. A second call is a no-op. Call it before any
    CUDA work: with NCCL the rank binds ``cuda:<LOCAL_RANK>``."""
    global _CPU_GROUP, _TIMEOUT, _IDENTITY, _BACKEND
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if world_size is None:
        for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
            val = env.get(var, "")
            if val.isdigit() and int(val) > 1:
                logging.getLogger(__name__).warning(
                    "%s=%s but no RANK/WORLD_SIZE set: every rank will run "
                    "SINGLE-PROCESS on the full dataset and race shared "
                    "output paths. Launch through torch.distributed.run "
                    "(or set RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) "
                    "to form one group.", var, val)
        return False
    if rank is None:
        raise ValueError(
            f"world size {world_size} without a rank: set RANK or pass "
            "rank=")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    timeout = _TIMEOUT = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    _CPU_GROUP = (dist.new_group(backend="gloo", timeout=timeout)
                  if backend != "gloo" else dist.group.WORLD)
    _IDENTITY, _BACKEND = (rank, world_size), backend
    return True


def set_identity(host_id: int, hosts: int, backend: str,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Name this process host ``host_id`` of ``hosts`` without forming a
    group: a host restarted into a degraded run joins the survivors'
    next generation through :func:`regroup` instead of the launch's
    rendezvous, whose store may have died with its old rank 0."""
    global _IDENTITY, _BACKEND, _TIMEOUT
    if not 0 <= int(host_id) < int(hosts):
        raise ValueError(f"host id {host_id} not in [0, {hosts})")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    _IDENTITY, _BACKEND = (int(host_id), int(hosts)), backend
    _TIMEOUT = datetime.timedelta(seconds=timeout_s)


def host_identity() -> tuple[int, int]:
    """(host id, hosts): the rank and world this process was launched
    with, the same in every generation; the current group's (0, 1 alone)
    when nothing named one."""
    return _IDENTITY if _IDENTITY is not None else host_shard()


def timeout_s() -> float:
    """The group timeout in seconds (every generation's)."""
    return _TIMEOUT.total_seconds()


def _teardown() -> None:
    """Drop the current group and the groups made over it. An NCCL group
    is aborted, not destroyed: destroying waits on communicators that
    hold a dead rank. Gloo closes its sockets."""
    global _CPU_GROUP
    if dist.is_initialized():
        if str(dist.get_backend()) == "nccl":
            from torch.distributed import distributed_c10d as c10d

            abort = getattr(c10d, "_abort_process_group", None)
            if abort is not None:
                abort()
            else:
                dist.destroy_process_group()
        else:
            dist.destroy_process_group()
    _CPU_GROUP = None
    _GROUPS.clear()


def shutdown() -> None:
    """Destroy the process group (a no-op when there is none) and forget
    the host identity."""
    global _IDENTITY, _BACKEND
    if dist.is_initialized():
        dist.destroy_process_group()
    _teardown()               # the caches
    _IDENTITY, _BACKEND = None, ""


def regroup(members, host_id: int, generation: int,
            store_dir: str) -> tuple[int, int]:
    """Membership generation ``generation`` over the hosts ``members``
    -> (this host's rank, world). The old group is torn down
    (:func:`_teardown`); with more than one member a new one forms, on
    the launch's backend, over a ``FileStore`` at
    ``<store_dir>/pg_<generation:04d>`` (every member passes the same
    directory), its rank the host's index in the sorted members, and the
    host-object group beside it. A single member forms none."""
    global _CPU_GROUP
    members = sorted({int(m) for m in members})
    if int(host_id) not in members:
        raise ValueError(f"host {host_id} is not a member of {members}")
    backend = _BACKEND or "gloo"
    rank, world = members.index(int(host_id)), len(members)
    with collective_span("regroup"):
        _teardown()
        if world > 1:
            store = dist.FileStore(
                os.path.join(store_dir, f"pg_{int(generation):04d}"), world)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world, timeout=_TIMEOUT)
            _CPU_GROUP = (dist.new_group(backend="gloo", timeout=_TIMEOUT)
                          if backend != "gloo" else dist.group.WORLD)
    return rank, world


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> str:
    """The process group's backend ("" without one)."""
    return str(dist.get_backend()) if dist.is_initialized() else ""


def host_shard() -> tuple[int, int]:
    """(rank, world): the ``Batcher`` ``host_shard`` argument."""
    return process_index(), process_count()


def local_device(device: torch.device) -> torch.device:
    """A bare ``cuda`` device under a launcher -> ``cuda:<LOCAL_RANK>``;
    anything else as given."""
    if (device.type == "cuda" and device.index is None
            and "LOCAL_RANK" in os.environ):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def group_of(ranks) -> object:
    """The process group over the global ``ranks`` (the world group when
    they are every rank). ``dist.new_group`` is collective over the whole
    world: every rank, member or not, must call this for each rank set in
    the same order. Cached by the sorted rank tuple, so a membership seen
    before (an actor set regrown) reuses its group."""
    key = tuple(sorted(int(r) for r in ranks))
    if key == tuple(range(process_count())):
        return dist.group.WORLD
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key), timeout=_TIMEOUT)
    return _GROUPS[key]


def barrier(op: str = "barrier") -> None:
    """Wait for every rank (on the host-object group)."""
    if not is_multiprocess():
        return
    with collective_span(op):
        dist.barrier(group=_CPU_GROUP)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def put_global(local_tree, device):
    """This rank's rows (numpy or tensors) -> tensors on its device. The
    rows are this rank's already (the host-sharded ``Batcher``), so
    single- and multi-process alike this is a placement."""
    return _tree_map(lambda x: torch.as_tensor(x).to(device), local_tree)


def put_full_global(full_tree, device, dim: int | None = None):
    """Every-rank-identical host arrays -> tensors on this rank's device:
    the whole array (``dim=None``, replicated), or this rank's contiguous
    block along ``dim`` (the seam tokens a resumed rank replays)."""
    rank, world = host_shard()

    def put(x):
        t = torch.as_tensor(np.asarray(x))
        if dim is not None and world > 1:
            n = t.shape[dim] // world
            t = t.narrow(dim, rank * n, n)
        return t.to(device)

    return _tree_map(put, full_tree)


def to_host_local(t) -> np.ndarray:
    """This rank's rows -> numpy."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def from_host_local(arr, device) -> torch.Tensor:
    """This rank's host rows -> a tensor on its device (the advantage
    upload)."""
    return torch.as_tensor(np.asarray(arr)).to(device)


def allgather_to_host(t, dim: int = 0) -> np.ndarray:
    """Every rank's rows, concatenated along ``dim`` in rank order, on
    every rank. Single-process: this rank's rows."""
    local = to_host_local(t)
    if not is_multiprocess():
        return local
    with collective_span("allgather_to_host"):
        src = torch.from_numpy(np.ascontiguousarray(local))
        parts = [torch.empty_like(src) for _ in range(process_count())]
        dist.all_gather(parts, src, group=_CPU_GROUP)
    return np.concatenate([p.numpy() for p in parts], axis=dim)


def _allgather_f64(values) -> np.ndarray:
    """[world, n] float64 of every rank's ``values`` (one collective)."""
    src = torch.tensor(np.asarray(values, np.float64).reshape(-1))
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src, group=_CPU_GROUP)
    return torch.stack(parts).numpy()


def global_scalar_mean(x: float) -> float:
    """Mean of a host scalar across ranks. Single-process: the identity."""
    if not is_multiprocess():
        return float(x)
    with collective_span("global_scalar_mean"):
        return float(np.mean(_allgather_f64([x])))


def _allgather_bytes(payload: bytes) -> list[bytes]:
    """Every rank's bytes, in rank order: two collectives (the lengths,
    then the max-padded bytes)."""
    data = np.frombuffer(payload, dtype=np.uint8)
    lengths = _allgather_f64([data.size]).reshape(-1).astype(np.int64)
    padded = torch.zeros((max(int(lengths.max()), 1),), dtype=torch.uint8)
    padded[: data.size] = torch.from_numpy(data.copy())
    rows = [torch.empty_like(padded) for _ in range(process_count())]
    dist.all_gather(rows, padded, group=_CPU_GROUP)
    return [bytes(rows[i][: int(lengths[i])].numpy())
            for i in range(len(rows))]


def allgather_pyobj(obj) -> list:
    """One JSON-serializable host object a rank -> ``[obj_0, ...,
    obj_{P-1}]`` in rank order on every rank: two collectives (the byte
    lengths, then the max-padded utf-8 bytes), as the JAX helper.
    Single-process: ``[obj]``."""
    if not is_multiprocess():
        return [obj]
    with collective_span("allgather_pyobj"):
        rows = _allgather_bytes(
            json.dumps(obj, default=float).encode("utf-8"))
        return [json.loads(r.decode("utf-8")) for r in rows]


def broadcast_pyobj(obj):
    """Rank 0's JSON-serializable object -> every rank (others' ``obj`` is
    ignored). Single-process: the object itself."""
    if not is_multiprocess():
        return obj
    return allgather_pyobj(obj if process_index() == 0 else None)[0]


def allgather_arrays(arrays: dict | None) -> list:
    """One dict of numpy arrays (or None) a rank -> every rank's, in rank
    order, on every rank, exact (``np.savez`` bytes through
    :func:`_allgather_bytes`). Single-process: ``[arrays]``."""
    if not is_multiprocess():
        return [arrays]
    with collective_span("allgather_arrays"):
        buf = io.BytesIO()
        if arrays is not None:
            np.savez(buf, **arrays)
        out = []
        for raw in _allgather_bytes(buf.getvalue()):
            if not raw:
                out.append(None)
                continue
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                out.append({k: z[k] for k in z.files})
        return out


def global_weighted_mean(value_sum: float, weight: float) -> float:
    """``sum(value_sum) / sum(weight)`` across ranks: the exact mean when
    ranks hold unequal row counts. A zero total weight gives 0.0.
    Single-process: the local ratio."""
    if not is_multiprocess():
        total_v, total_w = float(value_sum), float(weight)
    else:
        with collective_span("global_weighted_mean"):
            pair = _allgather_f64([value_sum, weight])
        total_v, total_w = (float(v) for v in pair.sum(axis=0))
    return total_v / total_w if total_w > 0.0 else 0.0


# ---- tensors between role ranks ---------------------------------------------

_TAG_BYTES = 16     # a transfer's header: two int64 words (the sender's tag)


def _staging(device: torch.device) -> torch.device:
    """Where a point-to-point buffer lives: the host under gloo (its send
    and recv take CPU tensors only), the device under NCCL."""
    return torch.device("cpu") if backend() == "gloo" else device


def _pack(tensors, tag) -> torch.Tensor:
    """The tag and every tensor's bytes, in order, as one uint8 tensor on
    the tensors' device."""
    dev = tensors[0].device
    head = torch.tensor([int(v) for v in tag], dtype=torch.int64, device=dev)
    return torch.cat([head.view(torch.uint8)] + [
        t.detach().contiguous().reshape(-1).view(torch.uint8)
        for t in tensors])


class Transfer:
    """A posted point-to-point transfer (:func:`post_send`,
    :func:`post_recv`). :meth:`wait` completes it inside
    ``collective_span``: a send returns None; a receive checks the
    sender's tag against the one it was posted with (a mismatch means the
    two ranks disagree on the schedule, and raises) and returns the
    tensors on ``device``."""

    def __init__(self, op: str, work, buf, tag, specs=None, device=None):
        self.op, self._work, self._buf, self.tag = op, work, buf, tag
        self._specs, self._device = specs, device

    def wait(self):
        with collective_span(self.op):
            self._work.wait()
        if self._specs is None:
            return None
        buf = self._buf.cpu() if self._buf.device.type != "cpu" \
            else self._buf
        got = tuple(buf[:_TAG_BYTES].clone().view(torch.int64).tolist())
        if got != tuple(self.tag):
            raise RuntimeError(
                f"{self.op}: a transfer tagged {got} arrived where "
                f"{tuple(self.tag)} was expected (the ranks disagree on "
                "the schedule)")
        out, off = [], _TAG_BYTES
        for shape, dtype in self._specs:
            n = int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
            out.append(self._buf[off:off + n].clone().view(dtype)
                       .reshape(shape).to(self._device))
            off += n
        return out


def post_send(tensors, dst: int, tag, op: str = "rl.handoff.send"
              ) -> Transfer:
    """Start sending ``tensors`` (with ``tag``, a pair of ints) to global
    rank ``dst``; the receiver posts :func:`post_recv` with the same
    shapes, dtypes and tag. The tensors are copied into the message first,
    so the caller may reuse them at once."""
    buf = _pack(tensors, tag).to(_staging(tensors[0].device))
    with collective_span(op):
        work = dist.isend(buf, int(dst))
    return Transfer(op, work, buf, tag)


def post_recv(specs, src: int, tag, device, op: str = "rl.handoff.recv"
              ) -> Transfer:
    """Start receiving the tensors ``specs`` (``(shape, dtype)`` pairs)
    from global rank ``src``; ``wait()`` returns them on ``device``."""
    n = _TAG_BYTES + sum(
        int(np.prod(shape, dtype=np.int64))
        * torch.empty((), dtype=dtype).element_size()
        for shape, dtype in specs)
    buf = torch.empty((n,), dtype=torch.uint8,
                      device=_staging(torch.device(device)))
    with collective_span(op):
        work = dist.irecv(buf, int(src))
    return Transfer(op, work, buf, tag, specs, device)


def broadcast_tensors(tensors, src: int, group,
                      op: str = "rl.actor.broadcast") -> None:
    """Global rank ``src``'s ``tensors`` -> the same tensors of every
    member of ``group``, in place: one flat buffer a dtype, one
    ``broadcast`` each."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    mine = process_index() == int(src)
    with collective_span(op):
        for dtype, ts in by_dtype.items():
            flat = (torch.cat([t.detach().reshape(-1) for t in ts]) if mine
                    else torch.empty((sum(t.numel() for t in ts),),
                                     dtype=dtype, device=ts[0].device))
            dist.broadcast(flat, src=int(src), group=group)
            if not mine:
                off = 0
                with torch.no_grad():
                    for t in ts:
                        t.copy_(flat[off:off + t.numel()].view_as(t))
                        off += t.numel()
