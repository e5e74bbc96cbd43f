"""CaptionService: caption serving with continuous batching.

A fixed pool of ``capacity`` decode lanes steps S-step strides; between
strides finished requests leave their lanes and queued requests take them.
The engine packs the lanes in flight into a dense prefix (``perm`` /
``inv`` / ``n_active``) and runs each stride once per live parameter
version, by the model's ``decode_impl``:

- ``"pallas"``: one launch of the stride kernel (``ops/decode_stride.py``),
  handed the page pools and the permuted page table (``paged=True``, the
  default there) or a dense bank gathered from them (``paged=False``);
- ``"xla"`` (every preset's default): the composite stride, S steps of
  ``decoding.common.lane_decode_step`` over every lane of a dense bank
  gathered from the pools (``paged`` must stay unset or False), each step
  masking the special tokens, blocking EOS per row while the request's
  own local step is below ``min_len``, then lane 0's argmax and the
  sampled lanes' ``argmax(logits / temperature + noise)``. The decode
  cell runs the additive-attention kernel at ``attention_impl="pallas"``
  (once a lane a step). ``num_rollouts=0`` serves the greedy lane alone.

**Per-request determinism.** A request's encoder output lands in its own
pages and every decode row reads only its own row. The sampled lanes'
Gumbel noise is a function of the request's seed, the lane, the request's
local step and the token (``decoding.counter_gumbel_noise``), so a request
served mid-flight beside others decodes exactly as it would alone.
``noise_fn`` replaces that noise (the parity tests feed the JAX service's
draws through it). Lane 0 is greedy; the answer is the NPAD pick, the
best-scoring lane. ``admit_group > 1`` encodes up to that many admissible
requests of one frame bucket in one pass; a batched float32 encoder GEMM
may differ from the solo one by a few ulps, so the knob trades that for
fewer encoder launches, and any other dtype falls back to one request a
pass.

**Hot parameter swaps.** :meth:`CaptionService.publish_params` stages a
new version; it applies at the next stride boundary, before admission.
Every request decodes under the version active when it was encoded. While
two versions have lanes in flight a stride launches once per version: the
other versions' lanes enter the kernel finished and get their carry,
token and finished back afterwards, their local step unchanged. A retained
version (its model and packed weights) is dropped once its last request
completes.

**Drain.** SIGTERM (``resilience.preempt.PreemptionHandler``),
:meth:`CaptionService.drain` or :func:`request_drain` stop the loop at the
next stride boundary. The in-flight, staged and queued requests persist to
``snapshot_dir`` (``queue.npz`` and ``manifest.json``, the JAX package's
layout, so either package replays the other's) and :func:`load_snapshot`
replays them from step 0, bit for bit by per-request determinism.

**Observability** (the JAX engine's names): the ``serving.admit``,
``serving.stage``, ``serving.encode``, ``serving.bind_staged``,
``serving.stride`` and ``serving.detok`` spans; the request funnel
(``serving.requests_submitted`` / ``_admitted`` / ``_completed``,
``serving.strides``), the per-request phase and latency histograms, the
page and lane gauges, the swap counters and the analytic
``flops.serving.*`` counters; :class:`SloMonitor`'s attainment and burn
gauges with its alerts through ``obs.anomaly.record_anomaly``; a drain
dumps a flight-recorder postmortem (:meth:`CaptionService._drain_postmortem`).
:meth:`CaptionService.stride_cost` gives one stride's analytic cost.

Chaos (``resilience/chaos.py``): the serve loop visits ``serving.step``
at the top of each iteration, before the SIGTERM check, and the swap visits
``serving.param_swap`` after reading the staged publish and before anything
changes, so a drain requested there refuses the swap: it is applied whole
or refused whole, never torn.

Peer loss: after the SIGTERM check the loop reads the active health
monitor's ``peer_lost`` flag (``resilience/health.py``) and drains with
reason ``"peer_loss"``: the snapshot holds the queue and the lanes in
flight, and ``load_snapshot`` replays them elsewhere.

The stride kernel refuses ``min_len > 0`` (its min-len mask is
stride-global) and ``num_rollouts < 1``; the composite stride serves both.
"""

from __future__ import annotations

import copy
import io
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_tpu_torch.decoding.common import (
    counter_gumbel_noise,
    forbid_special,
    lane_decode_step,
    npad_best_lane_index,
    selected_logprob,
    step_outputs,
)
from cst_captioning_tpu_torch.decoding.fused import fused_decode
from cst_captioning_tpu_torch.device import resolve_device
from cst_captioning_tpu_torch.models.captioner import CaptionModel, EncoderOutput
from cst_captioning_tpu_torch.obs import anomaly as obs_anomaly
from cst_captioning_tpu_torch.obs import recorder as obs_recorder
from cst_captioning_tpu_torch.obs.flops import (
    compiled_cost,
    enc_and_per_tok_flops,
    serving_bank_bytes_per_stride,
)
from cst_captioning_tpu_torch.ops.decode_stride import (
    StrideWeights,
    fused_decode_stride,
    fused_decode_stride_paged,
    stride_weights,
)
from cst_captioning_tpu_torch.resilience import chaos, health
from cst_captioning_tpu_torch.resilience.durable import (
    fsync_dir,
    write_bytes_durable,
)
from cst_captioning_tpu_torch.resilience.preempt import PreemptionHandler
from cst_captioning_tpu_torch.rl.scst import rollout_seed
from cst_captioning_tpu_torch.serving.pages import (
    OutOfPages,
    PageBank,
    gather_bank,
)

# (seeds [B] int64, local steps [S, B] int64, K, V) -> noise [S, K, B, V] f32
NoiseFn = Callable[[torch.Tensor, torch.Tensor, int, int], torch.Tensor]


@dataclass(frozen=True)
class ClipRequest:
    """One caption request: unbatched features ``[F, D]`` per modality,
    per-frame masks ``[F]``, and the request's own seed."""

    req_id: str
    feats: dict[str, np.ndarray]
    masks: dict[str, np.ndarray]
    seed: int = 0
    arrival_s: float = 0.0

    @property
    def num_frames(self) -> int:
        return int(next(iter(self.feats.values())).shape[0])


@dataclass
class CaptionResult:
    req_id: str
    tokens: np.ndarray        # [1+K, T] int32, lane 0 greedy
    logprobs: np.ndarray      # [1+K, T] float32 untempered model logprobs
    best_lane: int            # NPAD pick: argmax sum-logprob over lanes
    caption_ids: list[int]    # best lane up to (excluding) EOS
    caption: str | None       # detokenized when the service has a vocab
    latency_s: float          # arrival -> completion (queue wait included)
    phases: dict[str, float]  # queue_wait / encode / decode / detok seconds
    param_version: int = 0    # the version the request was encoded under


@dataclass
class ServeReport:
    results: dict[str, CaptionResult] = field(default_factory=dict)
    drained: bool = False
    drain_reason: str = ""
    snapshot_dir: str | None = None
    wall_s: float = 0.0
    submitted: int = 0
    completed: int = 0
    strides: int = 0


@dataclass
class _Ticket:
    req: ClipRequest
    slot: int = -1
    t: int = 0                      # local decode step
    tok: np.ndarray | None = None   # [G, T] accumulation buffers
    lp: np.ndarray | None = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_encoded: float = 0.0
    param_version: int = 0          # pinned at encode
    enc_carry: tuple | None = None  # parked until a lane binds


@dataclass
class _Lanes:
    """Device lane state, slot order: carry L x (c, h) [G, B, H]."""

    carry: list
    token: torch.Tensor      # [G, B] int32
    finished: torch.Tensor   # [G, B] bool; empty lanes are born finished
    t_local: torch.Tensor    # [B] int64 local step of each lane's request
    seeds: torch.Tensor      # [B] int64 request seed


class SloMonitor:
    """Rolling-window SLO attainment and multi-window burn-rate alerting.

    ``observe(latency_s, now)`` marks a completion ok iff ``latency_s <=
    target_s``, then for each window (default 1-min fast, 10-min slow)
    computes attainment = ok / total and burn rate = (1 - attainment) /
    (1 - objective), kept in ``attainment`` and ``burn`` by window. An
    alert trips when the fast window burns at ``fast_burn`` or more AND the
    slow one at ``slow_burn`` or more, edge-triggered: ``alerts`` counts
    excursions, ``breaches`` the requests past the target. ``now`` comes
    from the service's clock. The same values go to the obs registry:
    ``serving.slo.attainment.<w>s`` / ``serving.slo.burn_rate.<w>s``
    gauges, ``serving.slo.breaches`` / ``serving.slo.alerts`` counters,
    and each alert through ``record_anomaly("slo_burn", ...)``."""

    def __init__(
        self,
        target_s: float,
        objective: float = 0.99,
        windows: tuple[float, float] = (60.0, 600.0),
        fast_burn: float = 14.4,
        slow_burn: float = 6.0,
    ):
        if target_s <= 0:
            raise ValueError(f"slo target_s {target_s} must be > 0")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"slo objective {objective} must be in (0, 1)")
        if len(windows) != 2 or windows[0] >= windows[1]:
            raise ValueError(
                f"slo windows {windows} must be (fast, slow) with fast < slow"
            )
        self.target_s = float(target_s)
        self.objective = float(objective)
        self.windows = tuple(float(w) for w in windows)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self._samples: dict[float, deque] = {w: deque() for w in self.windows}
        self._alerting = False
        self.alerts = 0
        self.breaches = 0
        self.attainment: dict[float, float] = {}
        self.burn: dict[float, float] = {}

    def burn_rate(self, window: float, now: float) -> float:
        """Current burn rate over ``window`` (0.0 when no samples)."""
        dq = self._samples[window]
        while dq and dq[0][0] < now - window:
            dq.popleft()
        if not dq:
            return 0.0
        att = sum(ok for _, ok in dq) / len(dq)
        return (1.0 - att) / (1.0 - self.objective)

    def observe(self, latency_s: float, now: float) -> None:
        ok = latency_s <= self.target_s
        self.breaches += not ok
        if not ok:
            obs.counter("serving.slo.breaches").inc()
        for w in self.windows:
            dq = self._samples[w]
            dq.append((now, ok))
            while dq and dq[0][0] < now - w:
                dq.popleft()
            att = sum(o for _, o in dq) / len(dq)
            self.attainment[w] = att
            self.burn[w] = (1.0 - att) / (1.0 - self.objective)
            obs.gauge(f"serving.slo.attainment.{int(w)}s").set(att)
            obs.gauge(f"serving.slo.burn_rate.{int(w)}s").set(self.burn[w])
        fast, slow = self.windows
        firing = (self.burn[fast] >= self.fast_burn
                  and self.burn[slow] >= self.slow_burn)
        if firing and not self._alerting:
            self.alerts += 1    # one alert per excursion
            obs.counter("serving.slo.alerts").inc()
            obs_anomaly.record_anomaly(
                "slo_burn", target_s=self.target_s,
                fast_burn=self.burn[fast], slow_burn=self.burn[slow])
        self._alerting = firing


# the service inside serve(): the target of request_drain()
_ACTIVE: "CaptionService | None" = None
_ACTIVE_LOCK = threading.Lock()


def request_drain(reason: str = "requested") -> None:
    """Ask the service that is serving to drain at its next stride
    boundary."""
    with _ACTIVE_LOCK:
        svc = _ACTIVE
    if svc is None:
        raise RuntimeError("request_drain() with no CaptionService serving")
    svc.drain(reason)


class CaptionService:
    """Continuous-batching caption service over one model.

    ``capacity`` decode lanes, ``num_rollouts`` K sampled lanes per request
    (lane 0 greedy), ``stride`` steps per launch (default
    ``cfg.decode_stride``), EOS blocked while a request's local step is
    below ``min_len`` (the composite stride only). The paged bank holds
    ``num_pages`` pages of ``page_size`` slots; admission backpressures on
    page exhaustion. ``paged`` (default: the stride kernel is in use) reads
    the pages in the kernel; otherwise each stride gathers a dense bank.
    ``frame_bucket`` pads each clip's frame axis up to a multiple of it, so
    short clips hold fewer pages. ``admit_group`` caps the requests of one
    encoder pass (module docstring). ``slo_target_s > 0`` arms the
    :class:`SloMonitor`; ``feedback(req, result, param_version)`` is called
    at each completion. Runs on ``device`` (default the GPU); the model is
    moved there.
    """

    def __init__(
        self,
        model: CaptionModel,
        vocab=None,
        *,
        capacity: int = 8,
        num_rollouts: int = 2,
        temperature: float = 1.0,
        max_len: int | None = None,
        min_len: int = 0,
        stride: int | None = None,
        page_size: int | None = None,
        num_pages: int | None = None,
        frame_bucket: int | None = None,
        admit_group: int = 1,
        paged: bool | None = None,
        clock: Callable[[], float] = time.monotonic,
        slo_target_s: float = 0.0,
        slo_objective: float = 0.99,
        slo_fast_burn: float = 14.4,
        slo_slow_burn: float = 6.0,
        feedback: Callable[[ClipRequest, CaptionResult, int], None]
        | None = None,
        noise_fn: NoiseFn | None = None,
        device=None,
    ):
        cfg = model.cfg
        self.use_kernel = cfg.decode_impl == "pallas"
        if self.use_kernel and min_len > 0:
            raise ValueError(
                "decode_impl='pallas' serving does not support min_len > 0 "
                "(the stride kernel's min-len mask is stride-global, not "
                "per-row) — use the XLA decode path"
            )
        if self.use_kernel and num_rollouts < 1:
            raise ValueError(
                "decode_impl='pallas' serving needs num_rollouts >= 1 (the "
                "stride kernel requires the (1+K)-lane layout)"
            )
        if capacity < 1:
            raise ValueError(f"capacity {capacity} must be >= 1")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.vocab = vocab
        self.B = int(capacity)
        self.K = int(num_rollouts)
        self.G = 1 + self.K
        self.T = int(max_len or cfg.max_len)
        self.temperature = float(temperature)
        self.min_len = int(min_len)
        self.S = max(1, min(int(stride or cfg.decode_stride), self.T))
        self.n_mod = len(cfg.modalities)
        self.frame_bucket = int(frame_bucket or cfg.max_frames)
        if not 1 <= self.frame_bucket <= cfg.max_frames:
            raise ValueError(
                f"frame_bucket {self.frame_bucket} must be in "
                f"[1, max_frames={cfg.max_frames}]"
            )
        m_max = self.n_mod * cfg.max_frames
        page = int(page_size or self.n_mod * self.frame_bucket)
        pages_per_row = -(-m_max // page)
        if num_pages is None:
            num_pages = self.B * pages_per_row
        self.paged = self.use_kernel if paged is None else bool(paged)
        if self.paged and not self.use_kernel:
            raise ValueError(
                "paged=True needs decode_impl='pallas' — the XLA decode "
                "path has no in-kernel page reader (it runs the "
                "gather_bank fallback); leave paged unset or False"
            )
        if not self.paged and int(num_pages) > self.B * pages_per_row:
            raise ValueError(
                f"num_pages {num_pages} exceeds one batch's dense-bank "
                f"footprint ({self.B} lanes x {pages_per_row} pages): the "
                "dense-gather path can never admit the surplus; use "
                "decode_impl='pallas' with paged=True"
            )
        self.bank = PageBank(num_pages, page, self.device)
        self.table_width = pages_per_row
        self.bank.init_rows(self.B, self.table_width)
        # a batched bfloat16 encoder GEMM is not row-stable: other dtypes
        # encode one request a pass
        self.requested_admit_group = max(int(admit_group), 1)
        self.admit_group = (self.requested_admit_group
                            if cfg.dtype == "float32" else 1)
        if self.admit_group < self.requested_admit_group:
            obs.counter("serving.admit_group_bf16_fallback").inc()
            obs.event("serving_admit_group_fallback",
                      requested=self.requested_admit_group, dtype=cfg.dtype)
        self.clock = clock
        self._noise_fn = noise_fn or counter_gumbel_noise
        self._queue: deque[ClipRequest] = deque()
        self._tickets: dict[str, _Ticket] = {}
        self._inflight: dict[int, _Ticket] = {}   # slot -> ticket
        # encode-ahead staging (paged only): requests encoded and paged in
        # while every lane is busy bind a lane without an encode once one
        # frees; FIFO, ahead of new admissions
        self._staged: deque[str] = deque()
        self._free_slots: deque[int] = deque(range(self.B))
        self._lanes: _Lanes | None = None
        self._drain = threading.Event()
        self._drain_reason = ""
        self._slo_kw = dict(objective=slo_objective, fast_burn=slo_fast_burn,
                            slow_burn=slo_slow_burn)
        self._slo = (SloMonitor(slo_target_s, **self._slo_kw)
                     if slo_target_s > 0 else None)
        self._feedback = feedback
        # hot swaps: the active version is self.model with its packed
        # float32 stride weights (None on the composite stride); a version
        # that still has requests in flight keeps (model, weights) in
        # _old_versions
        self.param_version = 0
        self._weights: StrideWeights | None = None
        self._old_versions: dict[
            int, tuple[CaptionModel, StrideWeights | None]] = {}
        self._pending_publish: tuple[int, CaptionModel] | None = None
        self._swap_history: list[dict] = []
        obs.gauge("serving.param_version").set(0.0)
        # analytic encode and per-token FLOPs for the obs MFU counters
        self._enc_flops, self._tok_flops = enc_and_per_tok_flops(
            cfg.max_frames, cfg.d_embed, cfg.d_hidden, cfg.d_att,
            cfg.vocab_size, tuple(d for _, d in cfg.modalities),
            cfg.num_layers)

    # ---- public API ---------------------------------------------------------

    def submit(self, req: ClipRequest) -> None:
        if req.req_id in self._tickets:
            raise ValueError(f"duplicate req_id {req.req_id!r}")
        if not 1 <= req.num_frames <= self.model.cfg.max_frames:
            raise ValueError(
                f"request {req.req_id!r} has {req.num_frames} frames "
                f"(need 1..{self.model.cfg.max_frames})"
            )
        if not 0 <= req.seed < 2**31:
            raise ValueError(
                f"request {req.req_id!r} seed {req.seed} outside [0, 2^31)"
            )
        self._tickets[req.req_id] = _Ticket(req=req)
        self._queue.append(req)
        obs.counter("serving.requests_submitted").inc()

    def drain(self, reason: str = "requested") -> None:
        """Stop at the next stride boundary, refuse new admissions and
        snapshot the queue (safe from a signal handler or another
        thread)."""
        self._drain_reason = self._drain_reason or reason
        self._drain.set()

    @property
    def draining(self) -> bool:
        return self._drain.is_set()

    def grow_capacity(self, new_capacity: int) -> None:
        """Grow the lane pool between :meth:`serve` calls: new slots, the
        bank (``table_width`` pages per new lane) and the table rows grow,
        and existing lane state pads with lanes born finished (BOS, carry
        0, step 0, seed 0). Running requests are untouched. Only grows."""
        new_b = int(new_capacity)
        if new_b < self.B:
            raise ValueError(
                f"grow_capacity({new_capacity}) below current capacity "
                f"{self.B} — the lane pool only grows (shrink = drain and "
                "rebuild)"
            )
        grown = new_b - self.B
        if not grown:
            return
        self._free_slots.extend(range(self.B, new_b))
        self.B = new_b
        self.bank.grow(self.bank.num_pages + grown * self.table_width)
        self.bank.grow_rows(new_b)
        lanes = self._lanes
        if lanes is not None:
            def pad(x, fill):
                shape = list(x.shape)
                axis = 1 if x.ndim >= 2 else 0
                shape[axis] = grown
                return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                                device=x.device)], dim=axis)

            lanes.carry = [(pad(c, 0), pad(h, 0)) for c, h in lanes.carry]
            lanes.token = pad(lanes.token, BOS_ID)
            lanes.finished = pad(lanes.finished, True)
            lanes.t_local = pad(lanes.t_local, 0)
            lanes.seeds = pad(lanes.seeds, 0)
        obs.counter("serving.lanes_regrown").inc(grown)
        obs.event("serving_regrow", capacity=new_b, grown=grown)

    def set_slo(self, target_s: float) -> None:
        """(Re)arm the SLO monitor with a latency target; the windows
        restart. ``target_s <= 0`` disarms."""
        self._slo = (SloMonitor(target_s, **self._slo_kw)
                     if target_s > 0 else None)
        if self._slo is not None:
            obs.gauge("serving.slo.target_s").set(float(target_s))

    def slo_snapshot(self) -> dict | None:
        """The SLO monitor's target, objective and burn rate by window as
        of now (None when disarmed)."""
        mon = self._slo
        if mon is None:
            return None
        now = self.clock()
        return {
            "target_s": mon.target_s,
            "objective": mon.objective,
            "burn_rate": {f"{int(w)}s": round(mon.burn_rate(w, now), 4)
                          for w in mon.windows},
            "breach_alerts": mon.alerts,
            "param_version": self.param_version,
        }

    # ---- hot parameter swaps ------------------------------------------------

    def publish_params(self, params, version: int | None = None) -> bool:
        """Stage a new parameter version: a ``CaptionModel`` or its state
        dict, loaded into a copy of the served model (a JAX tree goes
        through ``convert.load_flax_params`` first). It applies at the next
        stride boundary. ``version`` (default one past the newest known)
        must be newer than the active and any pending version; a stale or
        duplicate publish, or one while draining, is refused and returns
        False. A newer publish supersedes a pending one."""
        floor = self.param_version
        if self._pending_publish is not None:
            floor = max(floor, self._pending_publish[0])
        version = floor + 1 if version is None else int(version)
        if version <= floor or self.draining:
            self._swap_refused(version, "stale_version" if version <= floor
                               else "draining")
            return False
        state = (params.state_dict() if isinstance(params, torch.nn.Module)
                 else params)
        model = copy.deepcopy(self.model)
        model.load_state_dict(state)
        self._pending_publish = (version, model)
        obs.event("serving_param_publish", version=version)
        return True

    def _swap_refused(self, version: int, reason: str) -> None:
        obs.counter("serving.param_swaps_refused").inc()
        obs.event("serving_param_swap_refused", version=version,
                  active=self.param_version, reason=reason)

    def _apply_pending_swap(self) -> bool:
        """Apply a staged publish: the only place the active version
        changes, at a stride boundary, so every stride runs whole
        versions. The outgoing version stays while requests pinned to it
        are in flight or staged."""
        if self._pending_publish is None:
            return False
        version, model = self._pending_publish
        chaos.visit("serving.param_swap")
        self._pending_publish = None
        if self.draining:
            self._swap_refused(version, "draining")
            return False
        prev = self.param_version
        if self._inflight or self._staged:
            self._old_versions[prev] = (self.model, self._weights)
        self.model = model
        self._weights = self._pack(model)
        self.param_version = version
        self._swap_history.append({"version": version, "from": prev,
                                   "inflight_pinned": len(self._inflight)})
        obs.counter("serving.param_swaps").inc()
        obs.gauge("serving.param_version").set(float(version))
        obs.event("serving_param_swap", version=version, prev=prev,
                  inflight_pinned=len(self._inflight))
        return True

    def _pack(self, model: CaptionModel) -> StrideWeights | None:
        """The stride kernel's packed weights of ``model`` (None on the
        composite stride, which steps the cell module)."""
        return stride_weights(model.cell) if self.use_kernel else None

    def _version(self, version: int
                 ) -> tuple[CaptionModel, StrideWeights | None]:
        if version == self.param_version:
            return self.model, self._weights
        return self._old_versions[version]

    def _retire_versions(self) -> None:
        """Drop retained versions no in-flight or staged request pins."""
        if not self._old_versions:
            return
        live = {t.param_version for t in self._inflight.values()}
        live |= {self._tickets[r].param_version for r in self._staged
                 if r in self._tickets}
        for v in [v for v in self._old_versions if v not in live]:
            del self._old_versions[v]
            obs.counter("serving.param_versions_retired").inc()

    # ---- the loop -----------------------------------------------------------

    def serve(self, requests: Iterable[ClipRequest] = (), *,
              snapshot_dir: str | None = None, realtime: bool = False,
              idle_wait_s: float = 0.002) -> ServeReport:
        """Run the admission/decode loop until the queue is empty or a
        drain is requested (then the rest goes to ``snapshot_dir``).
        ``realtime=True`` honors each request's ``arrival_s`` against the
        clock; otherwise every submitted request is admissible at once."""
        global _ACTIVE
        for req in sorted(requests, key=lambda r: r.arrival_s):
            self.submit(req)
        report = ServeReport(submitted=len(self._tickets))
        t0 = self.clock()
        now = lambda: self.clock() - t0  # noqa: E731
        with _ACTIVE_LOCK:
            prev_active, _ACTIVE = _ACTIVE, self
        pre = PreemptionHandler().install()
        try:
            with torch.no_grad():
                self._weights = self._pack(self.model)
                while True:
                    chaos.visit("serving.step")
                    if pre.requested:
                        self.drain("sigterm")
                    mon = health.active_monitor()
                    if mon is not None and mon.peer_lost:
                        self.drain("peer_loss")
                    if self.draining:
                        break
                    # a staged publish lands before admission, so every
                    # request admitted now pins the new version
                    self._apply_pending_swap()
                    self._admit_arrived(now, realtime)
                    if not self._inflight:
                        if not self._queue:
                            break
                        if not realtime:
                            raise OutOfPages(
                                "queue is non-empty but nothing can be "
                                "admitted: a single request needs more "
                                "pages than the whole pool"
                            )
                        time.sleep(idle_wait_s)
                        continue
                    self._run_stride(report, now)
            report.drained = self.draining
            report.drain_reason = self._drain_reason
            if self.draining:
                report.snapshot_dir = self._write_snapshot(snapshot_dir)
                obs.event("serving_drain", reason=self._drain_reason,
                          pending=len(self._queue),
                          inflight=len(self._inflight),
                          snapshot=report.snapshot_dir)
                obs.counter("serving.drains").inc()
                # before the release: the census below is live evidence
                self._drain_postmortem(report)
                self._release()
        finally:
            pre.uninstall()
            with _ACTIVE_LOCK:
                _ACTIVE = prev_active
        report.wall_s = now()
        report.completed = len(report.results)
        return report

    def _drain_postmortem(self, report: ServeReport) -> None:
        """A drained service leaves a flight-recorder postmortem bundle
        whose ``registry.json`` carries the SLO snapshot and the swap
        history: through the process-global recorder when one is
        configured (serving inside a training run), else an ephemeral one
        dropping the bundle next to the obs event stream, or into the drain
        snapshot. Best effort: a failed dump never breaks the drain (it
        counts on ``serving.drain_postmortem_error``)."""
        extra = {
            "serving": {
                "drain_reason": self._drain_reason,
                "pending": len(self._queue),
                "inflight": len(self._inflight),
                "slo": self.slo_snapshot(),
                "param_version": self.param_version,
                "param_swaps": len(self._swap_history),
                "swap_history": self._swap_history[-8:],
            }
        }
        fields = dict(drain_reason=self._drain_reason,
                      pending=len(self._queue), inflight=len(self._inflight))
        reason = f"serving_drain_{self._drain_reason or 'request'}"
        try:
            fr = obs_recorder.active()
            if fr is not None:
                fr.postmortem(reason, registry_extra=extra, **fields)
                return
            span_rec = obs.active()
            out_dir = (span_rec.out_dir if span_rec is not None
                       else report.snapshot_dir)
            if not out_dir:
                return  # no obs, no snapshot: nowhere durable to dump
            fr = obs_recorder.FlightRecorder(1, out_dir, run="serving",
                                             max_dumps=1)
            try:
                fr.postmortem(reason, registry_extra=extra, **fields)
            finally:
                fr.close()
        except Exception:  # noqa: BLE001 - counted: drains run on unwinds
            obs.counter("serving.drain_postmortem_error").inc()

    def stride_cost(self) -> dict | None:
        """The analytic cost of one stride at full occupancy (every lane, G
        lanes of S steps; ``obs.flops.compiled_cost``, ``backend:
        "analytic"``: the JAX engine reads XLA's cost analysis here). Bytes
        are the bank's (``serving_bank_bytes_per_stride``); the composite
        stride gathers the dense bank once (pool read, bank write) and its
        attention reads it on each of the G x S lane steps. None until the
        service has admitted a request (the pools exist then)."""
        if self._lanes is None or self.bank.mem is None:
            return None
        width = self.table_width * self.bank.page_size
        args = (self.B, width, int(self.bank.mem.shape[-1]),
                int(self.bank.proj.shape[-1]), self.bank.mem.element_size())
        if self.use_kernel:
            nbytes = serving_bank_bytes_per_stride(*args, paged=self.paged)
        else:
            nbytes = (2 + self.G * self.S) * serving_bank_bytes_per_stride(
                *args, paged=True)
        return compiled_cost(self.B * self.G * self.S * self._tok_flops,
                             nbytes)

    def _release(self) -> None:
        """Free a drained working set (after the snapshot took it)."""
        for slot in sorted(self._inflight):
            ticket = self._inflight.pop(slot)
            self.bank.clear_row(slot)
            self.bank.free(ticket.req.req_id)
            self._free_slots.append(slot)
            self._tickets.pop(ticket.req.req_id, None)
        for rid in self._staged:
            self.bank.free(rid)
            self._tickets.pop(rid, None)
        self._staged.clear()
        for req in self._queue:
            self._tickets.pop(req.req_id, None)
        self._queue.clear()
        self._old_versions.clear()

    # ---- admission ----------------------------------------------------------

    def _take_admissible(self, now, realtime: bool, lanes: int | None
                         ) -> dict[int, list[ClipRequest]]:
        """Pop queue-front requests that have arrived and fit the free
        pages (and, unless ``lanes`` is None, at most ``lanes`` of them),
        grouped by padded frame count. An admission (``lanes`` given) that
        stops for pages counts on ``serving.admission_blocked_pages``."""
        groups: dict[int, list[ClipRequest]] = {}
        reserved = 0
        while self._queue and (lanes is None or lanes > 0):
            req = self._queue[0]
            if realtime and req.arrival_s > now():
                break
            F = self._padded_frames(req)
            need = self.bank.pages_for(self.n_mod * F)
            if self.bank.free_pages - reserved < need:
                if lanes is not None:
                    obs.counter("serving.admission_blocked_pages").inc()
                break
            self._queue.popleft()
            groups.setdefault(F, []).append(req)
            reserved += need
            if lanes is not None:
                lanes -= 1
        return groups

    def _admit_groups(self, groups, now, stage: bool) -> None:
        name = "serving.stage" if stage else "serving.admit"
        for F, reqs in groups.items():
            for i in range(0, len(reqs), self.admit_group):
                chunk = reqs[i:i + self.admit_group]
                with obs.span(name, requests=len(chunk)):
                    self._admit_group(F, chunk, now, stage)

    def _admit_arrived(self, now, realtime: bool) -> None:
        # staged requests bind freed lanes first (they left the queue
        # earlier, so FIFO holds)
        while self._staged and self._free_slots:
            rid = self._staged.popleft()
            with obs.span("serving.bind_staged", req=rid):
                self._bind_lane(self._tickets[rid])
            obs.counter("serving.staged_bound").inc()
        groups = self._take_admissible(now, realtime, len(self._free_slots))
        self._admit_groups(groups, now, stage=False)
        # encode ahead while every lane is busy: a freed lane then binds
        # with no encode on its critical path
        sgroups = {}
        if self.paged and not self._free_slots:
            sgroups = self._take_admissible(now, realtime, None)
            self._admit_groups(sgroups, now, stage=True)
            obs.gauge("serving.staged").set(len(self._staged))
        if groups or sgroups or self._queue:
            obs.gauge("serving.queue_depth").set(len(self._queue))

    def _padded_frames(self, req: ClipRequest) -> int:
        b = self.frame_bucket
        return min(-(-req.num_frames // b) * b, self.model.cfg.max_frames)

    def _admit_group(self, F: int, reqs: list[ClipRequest], now,
                     stage: bool) -> None:
        t_admit = now()
        t_enc0 = time.perf_counter()
        with obs.span("serving.encode", requests=len(reqs)):
            enc = self._encode_batch(reqs, F)
        enc_s = (time.perf_counter() - t_enc0) / len(reqs)
        for i, req in enumerate(reqs):
            ticket = self._tickets[req.req_id]
            ticket.t_submit = ticket.t_submit or req.arrival_s
            ticket.t_admit = t_admit
            ticket.param_version = self.param_version
            row = slice(i, i + 1)
            pages = self.bank.alloc(req.req_id, enc.memory.shape[1])
            self.bank.store(pages, enc.memory[row], enc.memory_proj[row],
                            enc.memory_mask[row])
            ticket.t_encoded = now()
            ticket.enc_carry = tuple((c[row], h[row]) for c, h in enc.carry)
            self._ensure_lanes(ticket.enc_carry)
            if stage:
                self._staged.append(req.req_id)
                obs.counter("serving.requests_staged").inc()
            else:
                self._bind_lane(ticket)
            obs.counter("serving.requests_admitted").inc()
            obs.counter("flops.serving.encode").inc(self._enc_flops)
            obs.histogram("serving.queue_wait_seconds").observe(
                max(ticket.t_admit - ticket.t_submit, 0.0))
            obs.histogram("serving.encode_seconds").observe(enc_s)
        obs.gauge("serving.slots_in_use").set(len(self._inflight))
        obs.gauge("serving.pages_in_use").set(self.bank.pages_in_use)

    def _encode_batch(self, reqs: list[ClipRequest], F: int) -> EncoderOutput:
        """One encoder pass over ``reqs``, frames padded to ``F``."""
        feats, masks = {}, {}
        for name, _ in self.model.cfg.modalities:
            x = np.stack([
                np.pad(np.asarray(r.feats[name], np.float32),
                       ((0, F - r.num_frames), (0, 0))) for r in reqs])
            mk = np.stack([
                np.pad(np.asarray(r.masks[name], np.float32),
                       ((0, F - r.num_frames),)) for r in reqs])
            feats[name] = torch.from_numpy(x).to(self.device)
            masks[name] = torch.from_numpy(mk).to(self.device)
        return self.model.encode(feats, masks)

    def _ensure_lanes(self, enc_carry) -> None:
        if self._lanes is not None:
            return
        G, B, dev = self.G, self.B, self.device
        self._lanes = _Lanes(
            carry=[
                (torch.zeros((G, B) + c.shape[1:], dtype=c.dtype, device=dev),
                 torch.zeros((G, B) + h.shape[1:], dtype=h.dtype, device=dev))
                for c, h in enc_carry
            ],
            token=torch.full((G, B), BOS_ID, dtype=torch.int32, device=dev),
            finished=torch.ones((G, B), dtype=torch.bool, device=dev),
            t_local=torch.zeros((B,), dtype=torch.int64, device=dev),
            seeds=torch.zeros((B,), dtype=torch.int64, device=dev),
        )

    def _bind_lane(self, ticket: _Ticket) -> None:
        """Bind an encoded request to a free lane: page-table row, carry
        from its encoder output, BOS, its seed. No encoder work."""
        slot = self._free_slots.popleft()
        ticket.slot = slot
        ticket.tok = np.full((self.G, self.T), PAD_ID, np.int32)
        ticket.lp = np.zeros((self.G, self.T), np.float32)
        self._inflight[slot] = ticket
        self.bank.bind_row(slot, ticket.req.req_id)
        lanes = self._lanes
        for (c, h), (ec, eh) in zip(lanes.carry, ticket.enc_carry):
            c[:, slot] = ec[0]
            h[:, slot] = eh[0]
        lanes.token[:, slot] = BOS_ID
        lanes.finished[:, slot] = False
        lanes.t_local[slot] = 0
        lanes.seeds[slot] = ticket.req.seed
        ticket.enc_carry = None

    # ---- the stride ---------------------------------------------------------

    def _run_stride(self, report: ServeReport, now) -> None:
        active = sorted(self._inflight)
        n_active = len(active)
        rest = [s for s in range(self.B) if s not in self._inflight]
        perm_np = np.asarray(active + rest, np.int64)
        perm = torch.from_numpy(perm_np).to(self.device)
        inv = torch.from_numpy(np.argsort(perm_np, kind="stable")).to(
            self.device)
        by_ver: dict[int, list[int]] = {}
        for slot in active:
            by_ver.setdefault(self._inflight[slot].param_version,
                              []).append(slot)
        versions = sorted(by_ver)
        # the span holds the launches and the one readback a stride makes
        with obs.span("serving.stride", active=n_active,
                      versions=len(versions)):
            toks_np, lps_np, fin_np = self._launch(perm, inv, n_active,
                                                   by_ver, versions)
        report.strides += 1
        obs.counter("serving.strides").inc()
        obs.counter("flops.serving.stride").inc(
            n_active * self.G * self.S * self._tok_flops)
        obs.gauge("serving.pages.in_use").set(self.bank.pages_in_use)
        obs.gauge("serving.pages.free").set(self.bank.free_pages)
        obs.gauge("serving.pages.table_rows").set(self.B)
        if self.paged and self.bank.mem is not None:
            # the dense-gather path moves the bank 3 times a launch (pool
            # read, bank write, kernel read), the paged kernel once
            args = (self.B, self.table_width * self.bank.page_size,
                    int(self.bank.mem.shape[-1]),
                    int(self.bank.proj.shape[-1]),
                    self.bank.mem.element_size())
            obs.counter("serving.gather_bytes_avoided").inc(
                len(versions) * (serving_bank_bytes_per_stride(*args)
                                 - serving_bank_bytes_per_stride(
                                     *args, paged=True)))
        col = {slot: i for i, slot in enumerate(active)}
        for vi, v in enumerate(versions):
            for slot in by_ver[v]:
                ticket = self._inflight[slot]
                c = col[slot]
                n = min(self.S, self.T - ticket.t)
                ticket.tok[:, ticket.t:ticket.t + n] = toks_np[vi, :n, :, c].T
                ticket.lp[:, ticket.t:ticket.t + n] = lps_np[vi, :n, :, c].T
                ticket.t += n
                if fin_np[:, c].all() or ticket.t >= self.T:
                    self._complete(ticket, report, now)
        self._retire_versions()

    def _launch(self, perm, inv, n_active, by_ver, versions):
        """One stride: a kernel launch (or a composite stride) per live
        version, then the one readback -> (tokens [V, S, G, n], logprobs,
        finished [G, n])."""
        lanes = self._lanes
        # compaction permutes table rows, never pages
        table = self.bank.row_table[perm]
        lens = self.bank.row_lens[perm]
        steps = torch.arange(self.S, device=self.device)[:, None]
        # steps past T clamp to T-1: they only feed discarded emissions. A
        # lane's draws depend on its own step only, so one draw serves
        # every version's launch
        t_c = lanes.t_local[perm]
        ts = torch.clamp(t_c[None, :] + steps, max=self.T - 1)
        noise = self._noise_fn(lanes.seeds[perm], ts, self.K,
                               self.model.cfg.vocab_size)
        pools = (self.bank.mem, self.bank.proj, self.bank.mask)
        dense = None if self.paged else gather_bank(pools, table)
        kw = dict(steps=self.S, temperature=self.temperature, min_len=0,
                  num_layers=self.model.cfg.num_layers, mem_lens=lens)
        outs = []
        for v in versions:
            model, weights = self._version(v)
            carry = tuple((c[:, perm], h[:, perm]) for c, h in lanes.carry)
            token, fin = lanes.token[:, perm], lanes.finished[:, perm]
            keep = None
            fin_in = fin
            if len(versions) > 1:
                # the other versions' lanes enter finished and get their
                # pre-stride state back below
                in_v = torch.zeros(self.B, dtype=torch.bool)
                in_v[by_ver[v]] = True
                keep = in_v.to(self.device)[perm]
                fin_in = fin | ~keep[None, :]
            if self.paged:
                new_carry, toks, lps = fused_decode_stride_paged(
                    model.cell, carry, token, fin_in, *pools, table, noise,
                    0, n_active, weights=weights, **kw)
            elif self.use_kernel:
                new_carry, toks, lps = fused_decode_stride(
                    model.cell, carry, token, fin_in, *dense, noise, 0,
                    n_active, weights=weights, **kw)
            else:
                new_carry, toks, lps = self._composite_stride(
                    model, carry, token, fin_in, dense, noise, t_c)
            new_fin = fin_in | (toks == EOS_ID).any(dim=0)
            new_token = toks[-1]
            step = self.S
            if keep is not None:
                k2 = keep[None, :]
                k3 = keep[None, :, None]
                new_carry = [(torch.where(k3, nc, c), torch.where(k3, nh, h))
                             for (nc, nh), (c, h) in zip(new_carry, carry)]
                new_token = torch.where(k2, new_token, token)
                new_fin = torch.where(k2, new_fin, fin)
                step = self.S * keep[inv].long()
            lanes.carry = [(c[:, inv], h[:, inv]) for c, h in new_carry]
            lanes.token = new_token[:, inv].contiguous()
            lanes.finished = new_fin[:, inv].contiguous()
            lanes.t_local += step
            outs.append((toks[:, :, :n_active], lps[:, :, :n_active]))
        # the per-stride sync: the host acts on the emissions
        return (torch.stack([t for t, _ in outs]).cpu().numpy(),
                torch.stack([lp for _, lp in outs]).cpu().numpy(),
                lanes.finished[:, perm[:n_active]].cpu().numpy())

    def _composite_stride(self, model, carry, token, finished, bank, noise,
                          t_c):
        """S steps of the cell over every lane of the dense ``bank`` (the
        JAX engine's XLA scan stride): ``t_c`` [B] holds each lane's local
        step at the stride's start, so min_len holds per request ->
        (carry, tokens [S, G, B] int32, logprobs [S, G, B] float32)."""
        enc = EncoderOutput(*bank, ())
        steps = torch.arange(self.S, device=t_c.device)[:, None]
        blocked = (t_c[None, :] + steps) < self.min_len         # [S, B]
        toks, lps = [], []
        for s in range(self.S):
            carry, logits = lane_decode_step(model, carry, token, enc)
            logits = forbid_special(logits)
            if self.min_len > 0:
                logits[..., EOS_ID] = torch.where(
                    blocked[s][None, :], -1.0e9, logits[..., EOS_ID])
            nxt = logits[0].argmax(dim=-1)[None]
            if self.K:
                tl = logits[1:] / self.temperature
                nxt = torch.cat([nxt, (tl + noise[s]).argmax(dim=-1)])
            nxt = nxt.to(torch.int32)
            lp = selected_logprob(logits, nxt)
            token, lp, finished = step_outputs(nxt, lp, finished)
            toks.append(token)
            lps.append(lp)
        return carry, torch.stack(toks), torch.stack(lps)

    def _complete(self, ticket: _Ticket, report: ServeReport, now) -> None:
        with obs.span("serving.detok", req=ticket.req.req_id):
            t_det0 = time.perf_counter()
            best = int(npad_best_lane_index(ticket.lp))
            ids = _caption_ids(ticket.tok[best])
            caption = (self.vocab.decode(ticket.tok[best])
                       if self.vocab is not None else None)
            detok_s = time.perf_counter() - t_det0
        t_done = now()
        self._inflight.pop(ticket.slot)
        self._free_slots.append(ticket.slot)
        self.bank.clear_row(ticket.slot)
        self.bank.free(ticket.req.req_id)
        self._tickets.pop(ticket.req.req_id, None)
        latency = max(t_done - ticket.t_submit, 0.0)
        result = CaptionResult(
            req_id=ticket.req.req_id,
            tokens=ticket.tok,
            logprobs=ticket.lp,
            best_lane=best,
            caption_ids=ids,
            caption=caption,
            latency_s=latency,
            phases={
                "queue_wait": max(ticket.t_admit - ticket.t_submit, 0.0),
                "encode": max(ticket.t_encoded - ticket.t_admit, 0.0),
                "decode": max(t_done - ticket.t_encoded, 0.0),
                "detok": detok_s,
            },
            param_version=ticket.param_version,
        )
        report.results[ticket.req.req_id] = result
        obs.counter("serving.requests_completed").inc()
        obs.gauge("serving.slots_in_use").set(len(self._inflight))
        obs.gauge("serving.pages_in_use").set(self.bank.pages_in_use)
        obs.histogram("serving.decode_seconds").observe(
            result.phases["decode"])
        obs.histogram("serving.detok_seconds").observe(detok_s)
        obs.histogram("serving.latency_seconds").observe(latency)
        if self._slo is not None:
            # the service clock, as slo_snapshot reads it (the JAX engine
            # records serve-relative times here, so its snapshot's windows
            # are empty once the clock has run past them)
            self._slo.observe(latency, self.clock())
        obs.event("serving_request", req=ticket.req.req_id, latency_s=latency,
                  best_lane=best, steps=ticket.t,
                  param_version=ticket.param_version,
                  **{f"{k}_s": v for k, v in result.phases.items()})
        if self._feedback is not None:
            self._feedback(ticket.req, result, ticket.param_version)

    # ---- drain snapshots ----------------------------------------------------

    def _write_snapshot(self, snapshot_dir: str | None) -> str | None:
        """``queue.npz`` (``<i>.feats.<m>`` / ``<i>.masks.<m>``) and
        ``manifest.json`` under ``snapshot_dir``, fsync'd, the manifest
        renamed into place last. Order: in flight (by admission), staged,
        queued."""
        if snapshot_dir is None:
            return None
        os.makedirs(snapshot_dir, exist_ok=True)
        drained = [
            self._inflight[s].req for s in sorted(
                self._inflight, key=lambda s: self._inflight[s].t_admit)
        ] + [
            self._tickets[r].req for r in self._staged if r in self._tickets
        ] + list(self._queue)
        arrays: dict[str, np.ndarray] = {}
        manifest = {
            "requests": [],
            "page_table": self.bank.snapshot(),
            "in_flight_steps": {t.req.req_id: t.t
                                for t in self._inflight.values()},
            "staged": list(self._staged),
            "drain_reason": self._drain_reason,
        }
        for i, req in enumerate(drained):
            manifest["requests"].append({
                "req_id": req.req_id,
                "seed": req.seed,
                "arrival_s": req.arrival_s,
                "modalities": sorted(req.feats),
            })
            for name in req.feats:
                arrays[f"{i}.feats.{name}"] = np.asarray(req.feats[name],
                                                         np.float32)
                arrays[f"{i}.masks.{name}"] = np.asarray(req.masks[name],
                                                         np.float32)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        write_bytes_durable(os.path.join(snapshot_dir, "queue.npz"),
                            buf.getvalue())
        tmp = os.path.join(snapshot_dir, ".manifest.json.tmp")
        write_bytes_durable(tmp, json.dumps(manifest, indent=2).encode())
        os.replace(tmp, os.path.join(snapshot_dir, "manifest.json"))
        fsync_dir(snapshot_dir)
        return snapshot_dir


def load_snapshot(snapshot_dir: str, service: CaptionService | None = None,
                  grow_to: int | None = None) -> list[ClipRequest]:
    """A drained queue -> its requests, in the order the service would
    have run them (in-flight ones restart from step 0). With ``service``,
    they are submitted to it, after ``grow_to`` grows its lane pool."""
    with open(os.path.join(snapshot_dir, "manifest.json"),
              encoding="utf-8") as f:
        manifest = json.load(f)
    out: list[ClipRequest] = []
    with np.load(os.path.join(snapshot_dir, "queue.npz")) as data:
        for i, rec in enumerate(manifest["requests"]):
            mods = rec["modalities"]
            out.append(ClipRequest(
                req_id=rec["req_id"],
                feats={m: data[f"{i}.feats.{m}"] for m in mods},
                masks={m: data[f"{i}.masks.{m}"] for m in mods},
                seed=int(rec["seed"]), arrival_s=float(rec["arrival_s"]),
            ))
    if service is not None:
        if grow_to is not None:
            service.grow_capacity(grow_to)
        for req in out:
            service.submit(req)
        obs.counter("serving.requests_replayed").inc(len(out))
        obs.event("serving_replay", requests=len(out), capacity=service.B,
                  drain_reason=manifest.get("drain_reason", ""))
    return out


def _caption_ids(row: np.ndarray) -> list[int]:
    """A lane's tokens up to (excluding) EOS or PAD."""
    ids: list[int] = []
    for tok in row:
        tok = int(tok)
        if tok in (EOS_ID, PAD_ID):
            break
        ids.append(tok)
    return ids


# ---- the static-batching policy ----------------------------------------------


def static_batch_serve(
    model: CaptionModel,
    requests: list[ClipRequest],
    *,
    capacity: int = 8,
    num_rollouts: int = 2,
    temperature: float = 1.0,
    max_len: int | None = None,
    min_len: int = 0,
    vocab=None,
    service_seed: int = 0,
    realtime: bool = False,
    clock: Callable[[], float] = time.monotonic,
    idle_wait_s: float = 0.002,
    noise_fn: Callable[[int], Callable[[int], torch.Tensor]] | None = None,
    device=None,
) -> ServeReport:
    """The policy continuous batching is measured against: wait until
    ``capacity`` requests are queued (or no more are coming), decode the
    batch through ``decoding.fused.fused_decode`` and answer everyone
    together, with the same K lanes and NPAD pick.

    Batches have a fixed shape: a last partial batch pads with repeats of
    its first row (their outputs dropped). Batch ``i`` draws its noise from
    ``fused_decode``'s seed ``rl.rollout_seed(service_seed, 0, 0, i)``, or
    from ``noise_fn(i)`` (step -> [K, capacity, V]) when given."""
    dev = resolve_device(device)
    model = model.to(dev)
    T = int(max_len or model.cfg.max_len)
    F = model.cfg.max_frames
    pending = deque(sorted(requests, key=lambda r: r.arrival_s))
    report = ServeReport(submitted=len(pending))
    t0 = clock()
    now = lambda: clock() - t0  # noqa: E731
    batch_idx = 0
    while pending:
        arrived = sum(1 for r in pending if not realtime
                      or r.arrival_s <= now())
        if arrived < min(capacity, len(pending)):
            time.sleep(idle_wait_s)   # wait for a full batch
            continue
        batch = [pending.popleft()
                 for _ in range(min(capacity, len(pending)))]
        rows = batch + batch[:1] * (capacity - len(batch))
        feats, masks = {}, {}
        for name, _ in model.cfg.modalities:
            feats[name] = torch.from_numpy(np.stack([
                np.pad(np.asarray(r.feats[name], np.float32),
                       ((0, F - r.num_frames), (0, 0))) for r in rows])
            ).to(dev)
            masks[name] = torch.from_numpy(np.stack([
                np.pad(np.asarray(r.masks[name], np.float32),
                       ((0, F - r.num_frames),)) for r in rows])).to(dev)
        g, gl, s, sl = fused_decode(
            model, feats, masks, rollout_seed(service_seed, 0, 0, batch_idx),
            num_rollouts=num_rollouts, temperature=temperature, max_len=T,
            min_len=min_len,
            noise_fn=noise_fn(batch_idx) if noise_fn is not None else None)
        batch_idx += 1
        tok = torch.cat([g[None], s]).cpu().numpy()     # [1+K, capacity, T]
        lp = torch.cat([gl[None], sl]).cpu().numpy()
        t_done = now()
        for i, req in enumerate(batch):
            best = int(npad_best_lane_index(lp[:, i]))
            latency = max(t_done - (req.arrival_s if realtime else 0.0), 0.0)
            report.results[req.req_id] = CaptionResult(
                req_id=req.req_id, tokens=tok[:, i], logprobs=lp[:, i],
                best_lane=best, caption_ids=_caption_ids(tok[best, i]),
                caption=(vocab.decode(tok[best, i]) if vocab is not None
                         else None),
                latency_s=latency,
                phases={"queue_wait": 0.0, "encode": 0.0,
                        "decode": latency, "detok": 0.0},
            )
    report.wall_s = now()
    report.completed = len(report.results)
    return report
