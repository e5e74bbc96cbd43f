"""CaptionService: caption serving with continuous batching.

A fixed pool of ``capacity`` decode lanes steps S-step strides; between
strides finished requests leave their lanes and queued requests take them.
Each stride is one launch of the stride kernel
(``ops/decode_stride.py``): the engine packs the lanes in flight into a
dense prefix (``perm`` / ``inv`` / ``n_active``) and hands the kernel the
page pools and the permuted page table (``paged=True``, the default) or a
dense bank gathered from them (``paged=False``).

**Per-request determinism.** A request is encoded alone, its encoder output
lands in its own pages, and every decode row reads only its own row. The
sampled lanes' Gumbel noise is a function of the request's seed, the lane,
the request's local step and the token (``decoding.counter_gumbel_noise``),
so a request served mid-flight beside others decodes exactly as it would
alone. ``noise_fn`` replaces that noise (the parity tests feed the JAX
service's draws through it). Lane 0 is greedy; the answer is the NPAD pick,
the best-scoring lane.

Not carried from the JAX engine: drain and snapshots, hot parameter swaps,
the SLO monitor, chaos and health hooks, the feedback hook,
``grow_capacity``, ``static_batch_serve``, grouped admission encodes,
``min_len > 0`` and the XLA scan stride.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_tpu_torch.decoding.common import (
    counter_gumbel_noise,
    npad_best_lane_index,
)
from cst_captioning_tpu_torch.device import resolve_device
from cst_captioning_tpu_torch.models.captioner import CaptionModel, EncoderOutput
from cst_captioning_tpu_torch.ops.decode_stride import (
    fused_decode_stride,
    fused_decode_stride_paged,
    stride_weights,
)
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


@dataclass
class ServeReport:
    results: dict[str, CaptionResult] = field(default_factory=dict)
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
    enc_carry: tuple | None = None  # parked until a lane binds


@dataclass
class _Lanes:
    """Device lane state, slot order: carry L x (c, h) [G, B, H]."""

    carry: list
    token: torch.Tensor      # [G, B] int32
    finished: torch.Tensor   # [G, B] bool; empty lanes are born finished
    t_local: torch.Tensor    # [B] int64 local step of each lane's request
    seeds: torch.Tensor      # [B] int64 request seed


class CaptionService:
    """Continuous-batching caption service over one model.

    ``capacity`` decode lanes, ``num_rollouts`` K sampled lanes per request
    (lane 0 greedy), ``stride`` steps per launch (default
    ``cfg.decode_stride``). The paged bank holds ``num_pages`` pages of
    ``page_size`` slots; admission backpressures on page exhaustion.
    ``frame_bucket`` pads each clip's frame axis up to a multiple of it, so
    short clips hold fewer pages. Runs on ``device`` (default the GPU); the
    model is moved there.
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
        paged: bool = True,
        clock: Callable[[], float] = time.monotonic,
        noise_fn: NoiseFn | None = None,
        device=None,
    ):
        cfg = model.cfg
        if cfg.decode_impl != "pallas":
            raise ValueError(
                "the port serves through the stride kernel only: set "
                "decode_impl='pallas' (the JAX package's XLA scan stride is "
                "not ported)"
            )
        if min_len > 0:
            raise ValueError(
                "stride-kernel serving does not support min_len > 0 (the "
                "kernel's min-len mask is stride-global, not per-row)"
            )
        if num_rollouts < 1:
            raise ValueError(
                "stride-kernel serving needs num_rollouts >= 1 (the kernel "
                "requires the (1+K)-lane layout)"
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
        self.paged = bool(paged)
        if not self.paged and int(num_pages) > self.B * pages_per_row:
            raise ValueError(
                f"num_pages {num_pages} exceeds one batch's dense-bank "
                f"footprint ({self.B} lanes x {pages_per_row} pages): the "
                "dense-gather path can never admit the surplus; use "
                "paged=True"
            )
        self.bank = PageBank(num_pages, page, self.device)
        self.table_width = pages_per_row
        self.bank.init_rows(self.B, self.table_width)
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
        # the stride kernel's packed float32 weights, packed once per serve
        self._weights = None

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

    def serve(self, requests: Iterable[ClipRequest] = (), *,
              realtime: bool = False,
              idle_wait_s: float = 0.002) -> ServeReport:
        """Run the admission/decode loop until the queue is empty.
        ``realtime=True`` honors each request's ``arrival_s`` against the
        clock; otherwise every submitted request is admissible at once."""
        for req in sorted(requests, key=lambda r: r.arrival_s):
            self.submit(req)
        report = ServeReport(submitted=len(self._tickets))
        t0 = self.clock()
        now = lambda: self.clock() - t0  # noqa: E731
        with torch.no_grad():
            self._weights = stride_weights(self.model.cell)
            while True:
                self._admit_arrived(now, realtime)
                if not self._inflight:
                    if not self._queue:
                        break
                    if not realtime:
                        raise OutOfPages(
                            "queue is non-empty but nothing can be "
                            "admitted: a single request needs more pages "
                            "than the whole pool"
                        )
                    time.sleep(idle_wait_s)
                    continue
                self._run_stride(report, now)
        report.wall_s = now()
        report.completed = len(report.results)
        return report

    # ---- admission ----------------------------------------------------------

    def _admissible(self, now, realtime: bool) -> bool:
        req = self._queue[0]
        if realtime and req.arrival_s > now():
            return False
        need = self.bank.pages_for(self.n_mod * self._padded_frames(req))
        return self.bank.free_pages >= need

    def _admit_arrived(self, now, realtime: bool) -> None:
        # staged requests bind freed lanes first (they left the queue
        # earlier, so FIFO holds)
        while self._staged and self._free_slots:
            self._bind_lane(self._tickets[self._staged.popleft()])
        while self._queue and self._free_slots and self._admissible(
                now, realtime):
            self._admit(self._queue.popleft(), now, stage=False)
        # encode ahead while every lane is busy: a freed lane then binds
        # with no encode on its critical path
        if self.paged and not self._free_slots:
            while self._queue and self._admissible(now, realtime):
                self._admit(self._queue.popleft(), now, stage=True)

    def _padded_frames(self, req: ClipRequest) -> int:
        b = self.frame_bucket
        return min(-(-req.num_frames // b) * b, self.model.cfg.max_frames)

    def _admit(self, req: ClipRequest, now, stage: bool) -> None:
        ticket = self._tickets[req.req_id]
        ticket.t_submit = ticket.t_submit or req.arrival_s
        ticket.t_admit = now()
        enc = self._encode(req, self._padded_frames(req))
        pages = self.bank.alloc(req.req_id, enc.memory.shape[1])
        self.bank.store(pages, enc.memory, enc.memory_proj, enc.memory_mask)
        ticket.t_encoded = now()
        ticket.enc_carry = enc.carry
        self._ensure_lanes(enc.carry)
        if stage:
            self._staged.append(req.req_id)
        else:
            self._bind_lane(ticket)

    def _encode(self, req: ClipRequest, F: int) -> EncoderOutput:
        """One encoder pass for one request, frames padded to ``F``."""
        feats, masks = {}, {}
        for name, _ in self.model.cfg.modalities:
            x = np.asarray(req.feats[name], np.float32)
            mk = np.asarray(req.masks[name], np.float32)
            pad = F - x.shape[0]
            feats[name] = torch.from_numpy(
                np.pad(x, ((0, pad), (0, 0)))[None]).to(self.device)
            masks[name] = torch.from_numpy(
                np.pad(mk, ((0, pad),))[None]).to(self.device)
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
        lanes = self._lanes
        carry = tuple((c[:, perm], h[:, perm]) for c, h in lanes.carry)
        token, fin = lanes.token[:, perm], lanes.finished[:, perm]
        # compaction permutes table rows, never pages
        table = self.bank.row_table[perm]
        lens = self.bank.row_lens[perm]
        steps = torch.arange(self.S, device=self.device)[:, None]
        # steps past T clamp to T-1: they only feed discarded emissions
        ts = torch.clamp(lanes.t_local[perm][None, :] + steps, max=self.T - 1)
        noise = self._noise_fn(lanes.seeds[perm], ts, self.K,
                               self.model.cfg.vocab_size)
        pools = (self.bank.mem, self.bank.proj, self.bank.mask)
        kw = dict(steps=self.S, temperature=self.temperature, min_len=0,
                  num_layers=self.model.cfg.num_layers, mem_lens=lens,
                  weights=self._weights)
        cell = self.model.cell
        if self.paged:
            carry, toks, lps = fused_decode_stride_paged(
                cell, carry, token, fin, *pools, table, noise, 0, n_active,
                **kw)
        else:
            mem, proj, mask = gather_bank(pools, table)
            carry, toks, lps = fused_decode_stride(
                cell, carry, token, fin, mem, proj, mask, noise, 0, n_active,
                **kw)
        fin = fin | (toks == EOS_ID).any(dim=0)
        lanes.carry = [(c[:, inv], h[:, inv]) for c, h in carry]
        lanes.token = toks[-1][:, inv].contiguous()
        lanes.finished = fin[:, inv].contiguous()
        lanes.t_local += self.S
        # the per-stride sync: the host acts on the emissions
        toks_np = toks[:, :, :n_active].cpu().numpy()
        lps_np = lps[:, :, :n_active].cpu().numpy()
        fin_np = fin[:, :n_active].cpu().numpy()
        report.strides += 1
        for col, slot in enumerate(active):
            ticket = self._inflight[slot]
            n = min(self.S, self.T - ticket.t)
            ticket.tok[:, ticket.t:ticket.t + n] = toks_np[:n, :, col].T
            ticket.lp[:, ticket.t:ticket.t + n] = lps_np[:n, :, col].T
            ticket.t += n
            if fin_np[:, col].all() or ticket.t >= self.T:
                self._complete(ticket, report, now)

    def _complete(self, ticket: _Ticket, report: ServeReport, now) -> None:
        t_det0 = time.perf_counter()
        best = int(npad_best_lane_index(ticket.lp))
        row = ticket.tok[best]
        ids: list[int] = []
        for tok in row:
            tok = int(tok)
            if tok in (EOS_ID, PAD_ID):
                break
            ids.append(tok)
        caption = self.vocab.decode(row) if self.vocab is not None else None
        detok_s = time.perf_counter() - t_det0
        t_done = now()
        self._inflight.pop(ticket.slot)
        self._free_slots.append(ticket.slot)
        self.bank.clear_row(ticket.slot)
        self.bank.free(ticket.req.req_id)
        self._tickets.pop(ticket.req.req_id, None)
        report.results[ticket.req.req_id] = CaptionResult(
            req_id=ticket.req.req_id,
            tokens=ticket.tok,
            logprobs=ticket.lp,
            best_lane=best,
            caption_ids=ids,
            caption=caption,
            latency_s=max(t_done - ticket.t_submit, 0.0),
            phases={
                "queue_wait": max(ticket.t_admit - ticket.t_submit, 0.0),
                "encode": max(ticket.t_encoded - ticket.t_admit, 0.0),
                "decode": max(t_done - ticket.t_encoded, 0.0),
                "detok": detok_s,
            },
        )
