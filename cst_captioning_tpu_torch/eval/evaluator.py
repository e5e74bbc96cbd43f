"""Evaluation with the COCO-style metric table (the JAX package's
``eval/evaluator.py``), on one device.

Decode the split in fixed-shape batches (beam search, greedy, or NPAD),
ids -> words -> PTB tokens -> BLEU / ROUGE-L / METEOR_approx / CIDEr /
CIDEr-D; results keep the JAX package's schema ``{"split", "metrics",
"captions"}``.

``EvalConfig.pipelined`` (default) runs two stages: the device decodes
batch i+1 while a thread pool PTB-tokenizes batch i's captions and,
from the start, the reference pools. The drain gathers the shards in the
serial path's key order and scores the pre-tokenized tables, so the metric
table equals the serial evaluator's. ``timing`` holds the last pipelined
run's seconds: ``decode_s`` (decode calls and token readback), ``score_s``
(tokenizer work in the pool), ``wall_s``, ``fill_s`` and ``drain_s``.

Observability (the JAX evaluator's): an ``eval`` span per evaluation;
pipelined, the ``eval.pipeline.fill`` / ``eval.pipeline.drain`` /
``eval.score`` spans, the ``eval.decode_seconds`` (a batch's decode and
token readback) and ``eval.score_seconds`` (a tokenizer shard) histograms,
the ``eval.batches`` / ``eval.captions`` counters and the overlap gauges
(``eval.overlap_fraction``, ``eval.overlap_efficiency``, the stage totals
and ``eval.wall_s``) from the same seconds ``timing`` holds.

Data parallel (``mesh=``, a ``train.mesh.DataMesh`` of more than one
rank): each rank decodes its contiguous rows of every batch (the batch
size rounded up to a multiple of the world size; the Batcher wrap-pads
and marks the extra rows invalid), ``allgather_pyobj`` merges the caption
dicts, rank 0 scores and ``broadcast_pyobj`` fans the metrics out, so
every rank returns the one-rank result; only rank 0 writes
``results_json``. This path is the serial one (the pipelined drain needs
every caption on one host).

Sequence parallel (``mesh`` a ``('data', 'seq')`` ``GridMesh``, the model
an ``sp_model`` over its row): the batch rounds up to and shards over the
data axis, every rank of a row collating the same rows, and each rank
uploads only its shard of the frames (the dataset's ``max_frames`` must
divide over the row); greedy, beam and NPAD decode over the sharded bank,
and the merge is the data-parallel one (a row's ranks give the same
captions).

Model parallel (``mesh`` a ``('data', 'mp')`` ``GridMesh``): the batch
shards by the data coordinate, every rank of an ``'mp'`` row decodes the
same rows with the replicated kernels, as the JAX evaluator does, and the
merge is the data-parallel one.
"""

from __future__ import annotations

import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import EvalConfig
from cst_captioning_tpu_torch.data.batcher import Batcher
from cst_captioning_tpu_torch.decoding.beam import beam_search
from cst_captioning_tpu_torch.decoding.fused import npad_decode
from cst_captioning_tpu_torch.decoding.greedy import greedy_decode
from cst_captioning_tpu_torch.metrics.scorer import CaptionScorer
from cst_captioning_tpu_torch.metrics.tokenizer import ptb_tokenize
from cst_captioning_tpu_torch.parallel.seq_parallel import shard_frames
from cst_captioning_tpu_torch.train import multihost
from cst_captioning_tpu_torch.train.mesh import batch_sharding, is_seq_grid


def npad_batch_seed(npad_seed: int, batch_index: int) -> int:
    """The NPAD noise seed of one eval batch (its own counter-noise
    stream, as the JAX evaluator folds the batch index into its key)."""
    return (int(npad_seed) * 1_000_003 + int(batch_index)) & 0x7FFFFFFF


class Evaluator:
    """``dataset`` is any object with ``CaptionDataset``'s interface
    (``vocab``, ``split``, ``records``, ``stores``, ``max_frames``,
    ``features_for(vid)``, ``gts_pool()``). The decode reads ``model``'s
    weights as they are when it runs (a trainer updates them in place),
    on the model's device."""

    def __init__(self, model, dataset, cfg: EvalConfig | None = None,
                 batch_size: int = 32, mesh=None):
        self.model = model
        self.ds = dataset
        self.cfg = cfg = cfg or EvalConfig()
        self.mesh = mesh
        self.multiproc = mesh is not None and mesh.world > 1
        self.sp = is_seq_grid(mesh)
        if self.sp:
            S = mesh.seq.world
            if dataset.max_frames % S:
                raise ValueError(
                    f"model.max_frames {dataset.max_frames} must be "
                    f"divisible by mesh.seq_devices {S}")
            if model.encoder.seq is not mesh.seq:
                raise ValueError(
                    "a ('data', 'seq') mesh needs the model's frame axis "
                    "sharded over its row (parallel.seq_parallel.sp_model)")
        shard = batch_sharding(mesh) if self.multiproc else (0, 1)
        n_data = shard[1]
        if batch_size % n_data:
            # every batch size shards: the wrap-padded rows are invalid,
            # so the captions stay the one-rank ones
            padded = -(-batch_size // n_data) * n_data
            logging.getLogger(__name__).warning(
                "eval batch_size %d -> %d (next multiple of the %d-rank "
                "'data' axis; wrap-padded rows are masked out)",
                batch_size, padded, n_data)
            batch_size = padded
        # both scorers built (and so validated) up front; the pre-tokenized
        # one scores the pipelined drain and keeps its native CIDEr-D pool
        # across calls, as the serial one does
        self._scorer = CaptionScorer(metrics=cfg.metrics)
        self._scorer_pre = CaptionScorer(metrics=cfg.metrics,
                                         pre_tokenized=True)
        self.batcher = Batcher(
            dataset, batch_size=batch_size, max_len=cfg.max_len, mode="video",
            host_shard=shard)
        self.timing: dict[str, float] = {}
        W, T, ml = cfg.beam_size, cfg.max_len, cfg.min_len
        if cfg.npad_lanes > 0:
            # a rank draws the noise of its global rows
            row0 = self.batcher.host_shard[0] * self.batcher.local_batch_size
            self._decode = lambda m, f, k, bi: npad_decode(
                m, f, k, npad_batch_seed(cfg.npad_seed, bi),
                num_lanes=cfg.npad_lanes, temperature=cfg.npad_temperature,
                max_len=T, min_len=ml, row_offset=row0)[0]
        elif W > 1:
            self._decode = lambda m, f, k, bi: beam_search(
                m, f, k, beam_size=W, max_len=T, min_len=ml,
                length_penalty=cfg.length_penalty,
                beam_impl=cfg.beam_impl)[0]
        else:
            self._decode = lambda m, f, k, bi: greedy_decode(
                m, f, k, max_len=T, min_len=ml)[0]

    def _dispatch(self, batch, bi: int) -> torch.Tensor:
        """Upload batch ``bi``'s features and decode it -> tokens [B, T] on
        the model's device."""
        dev = self.model.device
        feats, masks = batch.feats, batch.feat_masks
        if self.sp:
            # only this rank's frames reach the device
            feats = shard_frames(self.mesh, feats)
            masks = shard_frames(self.mesh, masks)
        up = lambda d: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                        for k, v in d.items()}
        return self._decode(self.model, up(feats), up(masks), bi)

    def generate(self) -> dict[str, str]:
        """Decode every video of the split -> {video_id: caption string}.
        Batch i+1 is collated, uploaded and decoded before batch i's
        tokens become words."""
        out: dict[str, str] = {}

        def collect(tokens, batch):
            tok = tokens.cpu().numpy()
            for i, ok in enumerate(batch.valid):
                if ok:
                    out[batch.video_ids[i]] = self.ds.vocab.decode(tok[i])

        pending = None
        for bi, batch in enumerate(self.batcher.epoch(shuffle=False)):
            tokens = self._dispatch(batch, bi)
            if pending is not None:
                collect(*pending)
            pending = (tokens, batch)
        if pending is not None:
            collect(*pending)
        if self.multiproc:
            merged: dict[str, str] = {}
            for part in multihost.allgather_pyobj(out):
                merged.update(part)
            out = merged
        return out

    def _tok_res_shard(self, items):
        """[(vid, token row)] -> ([(vid, text, ptb tokens)], seconds)."""
        t0 = time.perf_counter()
        out = []
        for vid, row in items:
            text = self.ds.vocab.decode(row)
            out.append((vid, text, ptb_tokenize(text)))
        return out, time.perf_counter() - t0

    @staticmethod
    def _tok_gts_shard(items):
        """[(vid, [ref strings])] -> ([(vid, [ptb tokens])], seconds)."""
        t0 = time.perf_counter()
        out = [(vid, [ptb_tokenize(c) for c in caps]) for vid, caps in items]
        return out, time.perf_counter() - t0

    def _evaluate_pipelined(self):
        """The two-stage decode / tokenize pipeline -> (captions, metrics)."""
        wall0 = time.perf_counter()
        decode_total = 0.0
        score_total = 0.0
        dec_hist = obs.histogram("eval.decode_seconds")
        sc_hist = obs.histogram("eval.score_seconds")
        res_futs: list = []
        workers = self.cfg.score_workers
        with ThreadPoolExecutor(max_workers=workers) as pool:
            gts_items = [(vid, list(caps))
                         for vid, caps in self.ds.gts_pool().items()]
            shard = max(1, -(-len(gts_items) // workers))
            gts_futs = [pool.submit(self._tok_gts_shard,
                                    gts_items[i:i + shard])
                        for i in range(0, len(gts_items), shard)]

            def dispatch(batch, bi):
                """-> (tokens, batch, seconds of its decode call)."""
                t0 = time.perf_counter()
                tokens = self._dispatch(batch, bi)
                return tokens, batch, time.perf_counter() - t0

            def collect(tokens, batch, dt_dispatch):
                nonlocal decode_total
                t0 = time.perf_counter()
                tok = tokens.cpu().numpy()
                dt = dt_dispatch + time.perf_counter() - t0
                decode_total += dt
                dec_hist.observe(dt)
                obs.counter("eval.batches").inc()
                items = [(batch.video_ids[i], tok[i])
                         for i, ok in enumerate(batch.valid) if ok]
                obs.counter("eval.captions").inc(len(items))
                res_futs.append(pool.submit(self._tok_res_shard, items))

            # fill: batch 0's collate, upload and decode, before any
            # decode/score overlap can exist
            batches = enumerate(self.batcher.epoch(shuffle=False))
            with obs.span("eval.pipeline.fill"):
                t_f0 = time.perf_counter()
                bi, batch = next(batches, (None, None))
                pending = (dispatch(batch, bi) if batch is not None
                           else None)
                fill_s = time.perf_counter() - t_f0
            for bi, batch in batches:
                nxt = dispatch(batch, bi)
                collect(*pending)
                pending = nxt
            if pending is not None:
                collect(*pending)

            # drain: the shards in submission order (batch order for the
            # hypotheses, gts_pool order for the references), then the
            # corpus scorers, which need the whole split
            with obs.span("eval.pipeline.drain"):
                t_d0 = time.perf_counter()
                res_items: list = []
                for fut in res_futs:
                    out, dt = fut.result()
                    score_total += dt
                    sc_hist.observe(dt)
                    res_items.extend(out)
                gts_t: dict[str, list] = {}
                for fut in gts_futs:
                    out, dt = fut.result()
                    score_total += dt
                    sc_hist.observe(dt)
                    for vid, toks in out:
                        gts_t[vid] = toks
                gather_wait = time.perf_counter() - t_d0
                captions = {vid: text for vid, text, _ in res_items}
                res_t = {vid: [toks] for vid, _, toks in res_items}
                with obs.span("eval.score"):
                    metrics = self._scorer_pre.score(gts_t, res_t)
                drain_s = time.perf_counter() - t_d0
        wall_s = time.perf_counter() - wall0
        self.timing = {"decode_s": decode_total, "score_s": score_total,
                       "wall_s": wall_s, "fill_s": fill_s,
                       "drain_s": drain_s}
        # the overlap ledger: scoring seconds that did not stall the drain
        # hid under the decode; efficiency divides by the shorter stage
        overlap_s = max(0.0, score_total - gather_wait)
        hideable = min(decode_total, score_total)
        obs.gauge("eval.overlap_fraction").set(
            overlap_s / score_total if score_total > 0 else 0.0)
        obs.gauge("eval.overlap_efficiency").set(
            min(1.0, overlap_s / hideable) if hideable > 0 else 0.0)
        obs.gauge("eval.pipeline.fill_s").set(fill_s)
        obs.gauge("eval.pipeline.drain_s").set(drain_s)
        obs.gauge("eval.decode_total_s").set(decode_total)
        obs.gauge("eval.score_total_s").set(score_total)
        obs.gauge("eval.wall_s").set(wall_s)
        return captions, metrics

    def evaluate(self, results_json: str = "") -> dict[str, Any]:
        """Generate and score; write the results json when given a path.
        Several ranks take the serial path: rank 0 scores the merged
        captions and the metrics are broadcast; rank 0 alone writes."""
        with obs.span("eval", split=self.ds.split):
            if self.cfg.pipelined and not self.multiproc:
                captions, metrics = self._evaluate_pipelined()
                obs.snapshot_metrics(split=self.ds.split)
            else:
                captions = self.generate()
                metrics = None
                if not self.multiproc or self.mesh.rank == 0:
                    gts = {vid: list(caps)
                           for vid, caps in self.ds.gts_pool().items()}
                    res = {vid: [captions[vid]] for vid in captions}
                    with obs.span("eval.score"):
                        metrics = self._scorer.score(gts, res)
                if self.multiproc:
                    metrics = multihost.broadcast_pyobj(metrics)
        result = {"split": self.ds.split, "metrics": metrics,
                  "captions": captions}
        if results_json and self.multiproc and self.mesh.rank != 0:
            results_json = ""     # one writer on a shared file system
        if results_json:
            os.makedirs(os.path.dirname(results_json) or ".", exist_ok=True)
            with open(results_json, "w") as f:
                json.dump(result, f, indent=2, default=float)
        return result


def evaluate_split(model, dataset, cfg: EvalConfig | None = None,
                   batch_size: int = 32, results_json: str = "",
                   mesh=None) -> dict[str, Any]:
    return Evaluator(model, dataset, cfg, batch_size,
                     mesh=mesh).evaluate(results_json)
