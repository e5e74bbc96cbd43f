"""Durable TrainState checkpoints (the JAX package's ``ckpt/checkpoint.py``)
in a format the port owns, and a reader for the JAX package's.

Layout per checkpoint name (``best`` / ``latest`` / ``step_00001200``):

    <dir>/<name>/state.npz       params, optimizer state, step, seed
    <dir>/<name>/infos.json      epoch, phase, batch_index, config snapshot
    <dir>/<name>/manifest.json   sha256 + size per file, checked on load

``state.npz`` is an uncompressed numpy archive read with
``allow_pickle=False``: arrays under flax-path names in the JAX layout
(``params/cell/out_proj/kernel``; the Adam moments as
``opt_state/mu/<the same path>`` and ``opt_state/nu/...``), and the
scalars ``opt_state/count``, ``step`` and ``seed``. Each array keeps its
tensor's dtype: float32, or for a bfloat16 tensor (``param_dtype=
"bfloat16"``: the params, and their moments until a data-parallel or
chunked update widens them to float32) its ``uint16`` bit patterns,
2 bytes an element, since numpy has no bfloat16; a ``uint16`` array reads
back as bfloat16, bit for bit. A save moves the state to the host in one
copy a dtype (the tensors are packed into one buffer on the device
first), not a tensor at a time.

Saves are durable as the JAX package's are: every file is fsync'd in a
``<name>.tmp`` directory with a checksum manifest, an existing checkpoint
is demoted to ``<name>.prev``, the tmp directory is swapped in with
``os.replace`` and the parent directory fsync'd, so a crash at any point
leaves an intact generation.

A JAX checkpoint (``state.msgpack``, written by flax) loads through the
pure-Python decoder in ``ckpt/msgpack.py``: the params through
``convert.py``, the optax chain's Adam moments and count onto the port's
optimizer state, and the step (bfloat16 leaves bit for bit).
:func:`load_state`, :func:`load_params` and
``CheckpointManager.restore_latest`` read either format, by the state
file the directory holds. Saves and restores run in ``ckpt.save`` /
``ckpt.restore`` obs spans; a full disk and a corrupt candidate count on
``resilience.ckpt_enospc`` / ``resilience.ckpt_corrupt``. A save visits the
chaos points ``ckpt.save`` (entry), ``ckpt.state_written`` and
``ckpt.pre_replace`` (``resilience/chaos.py``).
"""

from __future__ import annotations

import errno
import io
import json
import os
import re
import shutil
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.ckpt import msgpack
from cst_captioning_tpu_torch.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from cst_captioning_tpu_torch.resilience import chaos
from cst_captioning_tpu_torch.resilience.durable import (
    CorruptCheckpointError,
    fsync_dir,
    verify_manifest,
    write_bytes_durable,
    write_manifest,
)
from cst_captioning_tpu_torch.resilience.retry import RetryPolicy, retry_call
from cst_captioning_tpu_torch.train.state import TrainState

STATE_FILE = "state.npz"
JAX_STATE_FILE = "state.msgpack"
INFOS_FILE = "infos.json"
MOMENTS = ("mu", "nu")

_STEP_NAME_RE = re.compile(r"^step_(\d+)$")


# ---- flat flax-path arrays <-> the port's tensors ----------------------------


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _names(model: torch.nn.Module) -> list[str]:
    return [n for n, _ in model.named_parameters()]


def _to_host(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """One device-to-host copy a dtype for all of ``tensors``, each in its
    own dtype."""
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1)
                          for i in idx]).cpu()
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view(tensors[i].shape)
            at += n
    return out


def state_arrays(state: TrainState) -> dict[str, np.ndarray]:
    """The state as ``state.npz``'s flat arrays."""
    cfg = state.model.cfg
    names = _names(state.model)
    n = len(names)
    moments = [m for m in MOMENTS if m in state.opt_state]
    host = _to_host(state.params + [t for m in moments
                                    for t in state.opt_state[m]])

    def flat(prefix, tensors):
        tree = state_dict_to_flax(cfg, dict(zip(names, tensors)),
                                  bits=True)["params"]
        return {f"{prefix}/{k}": v for k, v in _flatten(tree).items()}

    out = flat("params", host[:n])
    for i, m in enumerate(moments):
        out.update(flat(f"opt_state/{m}", host[n * (i + 1):n * (i + 2)]))
    out["opt_state/count"] = np.asarray(int(state.opt_state["count"]),
                                        np.int64)
    out["step"] = np.asarray(int(state.step), np.int64)
    out["seed"] = np.asarray(int(state.seed), np.int64)
    return out


def _params_list(model, tree) -> list[torch.Tensor]:
    """A flax params tree -> CPU tensors in ``model.parameters()`` order."""
    sd = flax_to_state_dict(model.cfg, tree)
    return [sd[n] for n in _names(model)]


def _read_port(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    opt = tree.get("opt_state", {})
    return {"params": tree["params"],
            "moments": {m: opt[m] for m in MOMENTS if m in opt},
            "count": int(opt["count"]), "step": int(tree["step"]),
            "seed": int(tree["seed"])}


def _find(tree: Any, pred) -> Any:
    """The first dict (depth first, keys in order) ``pred`` accepts."""
    if not isinstance(tree, dict):
        return None
    if pred(tree):
        return tree
    for k in sorted(tree, key=str):
        hit = _find(tree[k], pred)
        if hit is not None:
            return hit
    return None


def read_jax_state(blob: bytes) -> dict:
    """A JAX ``state.msgpack`` -> ``{"params", "moments", "count",
    "step"}``: the optax chain's ``ScaleByAdamState`` (``mu``, ``nu``,
    ``count``) or rmsprop's ``nu``, and the schedule's count where the
    chain keeps no Adam state."""
    sd = msgpack.restore(blob)
    for key in ("params", "opt_state", "step"):
        if key not in sd:
            raise CorruptCheckpointError(
                f"not a TrainState checkpoint: no {key!r} (keys {sorted(sd)})")
    opt = sd["opt_state"]
    adam = _find(opt, lambda d: "mu" in d and "nu" in d)
    rms = adam or _find(opt, lambda d: "nu" in d)
    counted = adam or _find(opt, lambda d: "count" in d)
    moments = {m: rms[m] for m in MOMENTS if rms is not None and m in rms}
    count = int(counted["count"]) if counted is not None else int(sd["step"])
    return {"params": sd["params"], "moments": moments, "count": count,
            "step": int(sd["step"])}


def _read(path: str) -> dict:
    """Verify ``path``'s manifest and read its state, either format."""
    verify_manifest(path)
    port = os.path.join(path, STATE_FILE)
    if os.path.exists(port):
        with open(port, "rb") as f:
            return _read_port(f.read())
    with open(os.path.join(path, JAX_STATE_FILE), "rb") as f:
        return read_jax_state(f.read())


def _install(state: TrainState, loaded: dict) -> TrainState:
    """Write a read state into ``state`` (its model in place)."""
    model = state.model
    params = _params_list(model, loaded["params"])
    moments = {m: _params_list(model, t)
               for m, t in loaded["moments"].items()}
    for p, v in zip(state.params, params):
        if tuple(p.shape) != tuple(v.shape):
            raise CorruptCheckpointError(
                f"checkpoint parameter shape {tuple(v.shape)} does not "
                f"match the model's {tuple(p.shape)}")
    dev = model.device
    with torch.no_grad():
        for p, v in zip(state.params, params):
            p.copy_(v)
    # the moments keep the file's dtypes, as a flax restore does (float32
    # moments of bfloat16 parameters after a data-parallel or chunked step)
    opt = {"count": int(loaded["count"])}
    for m, ts in moments.items():
        opt[m] = [t.to(dev) for t in ts]
    state.opt_state = opt
    state.step = int(loaded["step"])
    if "seed" in loaded:
        state.seed = int(loaded["seed"])
    return state


def _read_infos(path: str) -> dict:
    """Best-effort infos.json read for candidate ordering."""
    try:
        with open(os.path.join(path, INFOS_FILE), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


# ---- save / load --------------------------------------------------------------


def save_state(ckpt_dir: str, name: str, state: TrainState,
               infos: dict[str, Any] | None = None,
               extra_files: Mapping[str, bytes] | None = None) -> str:
    """Durably write state and infos under ``ckpt_dir/name``; returns the
    path. ``extra_files`` (name -> bytes, e.g. the RL ``seam.npz``) ride
    in the same swap under the same manifest. One writer per directory at
    a time: crash-atomic, not concurrency-atomic."""
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    chaos.visit("ckpt.save")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **state_arrays(state))
    state_bytes = buf.getvalue()
    infos_bytes = json.dumps(infos or {}, indent=2, default=float).encode()
    write_bytes_durable(os.path.join(tmp, STATE_FILE), state_bytes)
    chaos.visit("ckpt.state_written")
    write_bytes_durable(os.path.join(tmp, INFOS_FILE), infos_bytes)
    blobs = {STATE_FILE: state_bytes, INFOS_FILE: infos_bytes}
    for extra_name, blob in (extra_files or {}).items():
        if extra_name in blobs or os.sep in extra_name:
            raise ValueError(f"bad extra checkpoint file name {extra_name!r}")
        write_bytes_durable(os.path.join(tmp, extra_name), blob)
        blobs[extra_name] = blob
    write_manifest(tmp, blobs)
    fsync_dir(tmp)
    chaos.visit("ckpt.pre_replace")
    if os.path.exists(final):
        # demote, don't delete: the previous generation survives a crash
        # in the swap and a torn write in the new files
        prev = final + ".prev"
        if os.path.exists(prev):
            shutil.rmtree(prev)
        os.replace(final, prev)
    os.replace(tmp, final)
    fsync_dir(ckpt_dir)
    return final


def load_state(ckpt_dir: str, name: str,
               template: TrainState) -> tuple[TrainState, dict]:
    """Restore a checkpoint (the port's or the JAX package's) into
    ``template``: its model's parameters in place, its optimizer state,
    step and seed. The manifest is checked first, and everything is read
    and checked before ``template`` changes; raises
    :class:`CorruptCheckpointError` on a mismatch."""
    path = os.path.join(ckpt_dir, name)
    loaded = _read(path)
    state = _install(template, loaded)
    infos = _read_infos(path) if os.path.exists(
        os.path.join(path, INFOS_FILE)) else {}
    return state, infos


def load_params(ckpt_dir: str, name: str,
                model: torch.nn.Module) -> torch.nn.Module:
    """Parameters only, into ``model`` in place: the XE -> RL handoff
    (fresh optimizer), either format."""
    loaded = _read(os.path.join(ckpt_dir, name))
    params = _params_list(model, loaded["params"])
    with torch.no_grad():
        for p, v in zip(model.parameters(), params):
            if tuple(p.shape) != tuple(v.shape):
                raise CorruptCheckpointError(
                    f"checkpoint parameter shape {tuple(v.shape)} does not "
                    f"match the model's {tuple(p.shape)}")
            p.copy_(v)
    return model


# ---- the manager ---------------------------------------------------------------


class CheckpointManager:
    """Best-by-metric and latest, mid-epoch ``step_*`` checkpoints with
    keep-last-K rotation, and checksum-verified auto-resume. ``last_save``
    holds the ``ms`` and ``bytes`` written of the last :meth:`save` (both
    ``latest`` and ``best`` when it wrote both) or :meth:`save_step`,
    ``last_restore`` the last restore's ``ms``."""

    def __init__(self, ckpt_dir: str, metric: str = "CIDEr-D",
                 mode: str = "max", keep: int = 3,
                 log: Callable[..., None] | None = None,
                 retry: RetryPolicy | None = None):
        self.ckpt_dir = ckpt_dir
        self.metric = metric
        self.mode = mode
        self.keep = keep
        self.log = log or (lambda event, **fields: None)
        self.retry = retry or RetryPolicy()
        self.best_value: float | None = None
        self.last_save: dict[str, float] = {}
        self.last_restore: dict[str, float] = {}
        os.makedirs(ckpt_dir, exist_ok=True)
        best_infos = os.path.join(ckpt_dir, "best", INFOS_FILE)
        if os.path.exists(best_infos):
            with open(best_infos) as f:
                self.best_value = json.load(f).get("best_value")

    def _improved(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return (value > self.best_value if self.mode == "max"
                else value < self.best_value)

    def _save(self, name: str, state: TrainState, infos: dict,
              extra_files: Mapping[str, bytes] | None = None) -> str:
        """One durable save with retries on transient I/O errors; a full
        disk first frees the oldest ``step_*`` (then a ``*.prev``)."""

        def attempt():
            try:
                return save_state(self.ckpt_dir, name, state, infos,
                                  extra_files=extra_files)
            except OSError as e:
                if getattr(e, "errno", None) == errno.ENOSPC:
                    freed = self._reclaim_space(exclude=name)
                    obs.counter("resilience.ckpt_enospc").inc()
                    self.log("ckpt_enospc", name=name, freed=freed,
                             detail=str(e))
                raise

        t0 = time.perf_counter()
        # the span covers retries and backoff: its duration is the stall a
        # save puts on the step loop
        with obs.span("ckpt.save", ckpt=name):
            path = retry_call(
                attempt, policy=self.retry,
                on_retry=lambda info: self.log("ckpt_retry", name=name,
                                               **info))
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        self.last_save = {"ms": (time.perf_counter() - t0) * 1e3,
                          "bytes": size}
        return path

    def _reclaim_space(self, exclude: str = "") -> list[str]:
        victims: list[str] = []
        for _, step_name in self.step_checkpoints():
            if step_name != exclude:
                victims.append(step_name)
                break
        if not victims:
            victims = sorted(
                e for e in os.listdir(self.ckpt_dir)
                if e.endswith(".prev") and e != f"{exclude}.prev"
                and os.path.isdir(os.path.join(self.ckpt_dir, e)))[:1]
        for victim in victims:
            shutil.rmtree(os.path.join(self.ckpt_dir, victim),
                          ignore_errors=True)
        return victims

    def save(self, state: TrainState, value: float | None = None,
             infos: dict | None = None) -> bool:
        """Save ``latest``; also ``best`` when the metric improves.
        Returns True on a new best."""
        infos = dict(infos or {})
        improved = value is not None and self._improved(value)
        if improved:
            self.best_value = float(value)
        # both carry the post-update best, so latest never lags best
        infos["best_value"] = self.best_value
        self._save("latest", state, infos)
        total = dict(self.last_save)
        if improved:
            self._save("best", state, infos)
            total = {k: total[k] + self.last_save[k] for k in total}
        self.last_save = total
        return improved

    def save_step(self, state: TrainState, step: int,
                  infos: dict | None = None,
                  extra_files: Mapping[str, bytes] | None = None) -> str:
        """Mid-epoch ``step_<n>`` checkpoint and keep-last-``keep``."""
        infos = dict(infos or {})
        infos.setdefault("global_step", int(step))
        infos["best_value"] = self.best_value
        path = self._save(f"step_{int(step):08d}", state, infos,
                          extra_files=extra_files)
        if self.keep > 0:
            for _, name in self.step_checkpoints()[:-self.keep]:
                shutil.rmtree(os.path.join(self.ckpt_dir, name),
                              ignore_errors=True)
        return path

    def step_checkpoints(self) -> list[tuple[int, str]]:
        """Existing ``step_*`` checkpoints as (step, dirname), ascending."""
        out = []
        for entry in os.listdir(self.ckpt_dir):
            m = _STEP_NAME_RE.match(entry)
            if m and os.path.isdir(os.path.join(self.ckpt_dir, entry)):
                out.append((int(m.group(1)), entry))
        return sorted(out)

    def _candidates(self) -> list[str]:
        """Restore candidates, newest first: by the training position the
        infos record, ``(epoch, batch_index, global_step)`` (completed
        epochs, then batches into the next one), ties broken by role
        (``latest`` > ``step_*`` > ``best`` > a demoted ``*.prev``); a
        missing field counts as -1.

        The JAX package orders by ``global_step`` alone, but the step
        counter restarts at the XE -> RL handoff, so there an RL save
        ranks below the XE checkpoints and a mid-RL resume would restore
        the XE state; the epoch counter runs across both phases."""
        rank = {"latest": 3, "best": 1}
        cands = []
        for entry in sorted(os.listdir(self.ckpt_dir)):
            path = os.path.join(self.ckpt_dir, entry)
            if entry.endswith(".tmp") or not os.path.isdir(path):
                continue
            if not any(os.path.exists(os.path.join(path, f))
                       for f in (STATE_FILE, JAX_STATE_FILE)):
                continue
            base = entry[:-5] if entry.endswith(".prev") else entry
            role = 0 if entry.endswith(".prev") else (
                rank.get(base, 2 if _STEP_NAME_RE.match(base) else 0))
            infos = _read_infos(path)
            pos = tuple(-1 if infos.get(k) is None else int(infos[k])
                        for k in ("epoch", "batch_index", "global_step"))
            cands.append((pos, role, entry))
        return [e for _, _, e in sorted(cands, reverse=True)]

    def restore_latest(self, template: TrainState,
                       prefer: str | None = None
                       ) -> tuple[TrainState, dict] | None:
        """The newest checkpoint that passes verification, into
        ``template``. A failing candidate is logged as ``ckpt_corrupt``
        (name, error, detail) and the next one is tried. ``prefer`` is
        tried first."""
        t0 = time.perf_counter()
        with obs.span("ckpt.restore"):
            cands = self._candidates()
            if prefer is not None and prefer in cands:
                cands = [prefer] + [c for c in cands if c != prefer]
            for name in cands:
                try:
                    state, infos = load_state(self.ckpt_dir, name, template)
                except Exception as e:  # noqa: BLE001 - logged, next one
                    obs.counter("resilience.ckpt_corrupt").inc()
                    self.log("ckpt_corrupt", name=name,
                             error=type(e).__name__, detail=str(e))
                    continue
                infos.setdefault("ckpt_name", name)
                self.last_restore = {"ms": (time.perf_counter() - t0) * 1e3}
                return state, infos
            return None
