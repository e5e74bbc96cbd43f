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

Not ported: meshes, multi-host evaluation, sequence parallelism and the
obs spans and gauges (ROADMAP.md names their slices).
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from cst_captioning_tpu_torch.config import EvalConfig
from cst_captioning_tpu_torch.data.batcher import Batcher
from cst_captioning_tpu_torch.decoding.beam import beam_search
from cst_captioning_tpu_torch.decoding.fused import npad_decode
from cst_captioning_tpu_torch.decoding.greedy import greedy_decode
from cst_captioning_tpu_torch.metrics.scorer import CaptionScorer
from cst_captioning_tpu_torch.metrics.tokenizer import ptb_tokenize


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
                 batch_size: int = 32):
        self.model = model
        self.ds = dataset
        self.cfg = cfg = cfg or EvalConfig()
        # both scorers built (and so validated) up front; the pre-tokenized
        # one scores the pipelined drain and keeps its native CIDEr-D pool
        # across calls, as the serial one does
        self._scorer = CaptionScorer(metrics=cfg.metrics)
        self._scorer_pre = CaptionScorer(metrics=cfg.metrics,
                                         pre_tokenized=True)
        self.batcher = Batcher(dataset, batch_size=batch_size,
                               max_len=cfg.max_len, mode="video")
        self.timing: dict[str, float] = {}
        W, T, ml = cfg.beam_size, cfg.max_len, cfg.min_len
        if cfg.npad_lanes > 0:
            self._decode = lambda m, f, k, bi: npad_decode(
                m, f, k, npad_batch_seed(cfg.npad_seed, bi),
                num_lanes=cfg.npad_lanes, temperature=cfg.npad_temperature,
                max_len=T, min_len=ml)[0]
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
        up = lambda d: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                        for k, v in d.items()}
        return self._decode(self.model, up(batch.feats), up(batch.feat_masks),
                            bi)

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
                nonlocal decode_total
                t0 = time.perf_counter()
                tokens = self._dispatch(batch, bi)
                decode_total += time.perf_counter() - t0
                return tokens

            def collect(tokens, batch):
                nonlocal decode_total
                t0 = time.perf_counter()
                tok = tokens.cpu().numpy()
                decode_total += time.perf_counter() - t0
                items = [(batch.video_ids[i], tok[i])
                         for i, ok in enumerate(batch.valid) if ok]
                res_futs.append(pool.submit(self._tok_res_shard, items))

            batches = enumerate(self.batcher.epoch(shuffle=False))
            t_f0 = time.perf_counter()
            bi, batch = next(batches, (None, None))
            pending = ((dispatch(batch, bi), batch) if batch is not None
                       else None)
            fill_s = time.perf_counter() - t_f0
            for bi, batch in batches:
                tokens = dispatch(batch, bi)
                collect(*pending)
                pending = (tokens, batch)
            if pending is not None:
                collect(*pending)

            # drain: the shards in submission order (batch order for the
            # hypotheses, gts_pool order for the references), then the
            # corpus scorers, which need the whole split
            t_d0 = time.perf_counter()
            res_items: list = []
            for fut in res_futs:
                out, dt = fut.result()
                score_total += dt
                res_items.extend(out)
            gts_t: dict[str, list] = {}
            for fut in gts_futs:
                out, dt = fut.result()
                score_total += dt
                for vid, toks in out:
                    gts_t[vid] = toks
            captions = {vid: text for vid, text, _ in res_items}
            res_t = {vid: [toks] for vid, _, toks in res_items}
            metrics = self._scorer_pre.score(gts_t, res_t)
            drain_s = time.perf_counter() - t_d0
        self.timing = {"decode_s": decode_total, "score_s": score_total,
                       "wall_s": time.perf_counter() - wall0,
                       "fill_s": fill_s, "drain_s": drain_s}
        return captions, metrics

    def evaluate(self, results_json: str = "") -> dict[str, Any]:
        """Generate and score; write the results json when given a path."""
        if self.cfg.pipelined:
            captions, metrics = self._evaluate_pipelined()
        else:
            captions = self.generate()
            gts = {vid: list(caps) for vid, caps in self.ds.gts_pool().items()}
            res = {vid: [captions[vid]] for vid in captions}
            metrics = self._scorer.score(gts, res)
        result = {"split": self.ds.split, "metrics": metrics,
                  "captions": captions}
        if results_json:
            os.makedirs(os.path.dirname(results_json) or ".", exist_ok=True)
            with open(results_json, "w") as f:
                json.dump(result, f, indent=2, default=float)
        return result


def evaluate_split(model, dataset, cfg: EvalConfig | None = None,
                   batch_size: int = 32,
                   results_json: str = "") -> dict[str, Any]:
    return Evaluator(model, dataset, cfg, batch_size).evaluate(results_json)
