#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cst_captioning_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases PHASE[,PHASE ...]

With ``--phases`` only the named phases run, each check recorded instead
of raised (``run_phases``): ``data_parallel`` (8d), ``seq_parallel``
(8g) and ``model_parallel`` (8h, both on the same corpus and start
weights), ``scst[:N]`` (phase 6 N times, each in a process of its
own), ``syncs`` (6f, after the models it drives are built and
fitted), ``serve_composite`` (3c, after kernel 1's decode-shape
lines and phase 3's kernel serve) and ``param_bf16`` (6g, on the train
corpus and the serve burst); each phase's line is followed by
``{"gates": PHASE, "failed": [...]}``, and the run exits 1 if a check
failed.

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the kernels' build (nvcc, from the sources in the repo).
2. kernels: every CUDA kernel of the serving, training and eval paths, called
   through its wrapper on tensors on the card at the shapes those paths
   give it, held against its plain PyTorch version on the same inputs:
   - the stride kernels (dense, paged) at the serving shapes (capacity 32,
     K=2, S=8, msrvtt width: V=9000, E=H=512, A=256, 56 memory slots),
     float32 and bfloat16 pools, and the dense one at the SCST decode's
     (B=64, K=1, bfloat16 bank; timed too, and split by phase from the
     kernel's own timeline). Tokens must be equal except at argmax
     near-ties (the plain version's top-2 gap at the first divergence
     <= 1e-3); logprobs and the carry of rows still live within 1e-4;
   - the additive-attention kernel at the XE step's B=64 and the REINFORCE
     update's B=320 (M=56, the training model's own encoder output) and at
     M=1000 (ragged masks, one fully masked row), float32 within 1e-4 of
     the plain version; bfloat16 within 2^-8 of the value (its output's
     one rounding) plus 1e-3 of the row's largest value of the kernel's
     numerics in float32 (``additive_attention_f32``; the plain composite
     also rounds scores and weights to bfloat16, so its distance is only
     reported); its gradient equals the plain version's autograd; and at
     the composite serving stride's shape (B=32 rows, one query each,
     over the dense bank's M=56 slots, bfloat16, no gradient), checked
     and timed (``decode_attention``: event medians in turns with the
     plain version, device time, the bound);
   - the decode-step kernel at G=5, B=64 through the rollout's in-place
     wrapper, float32 bank and carry, and bfloat16 bank and carry (the
     rollout's), and at G=1 (greedy decoding's shape): logits within 1e-4,
     the carry within 1e-4 plus one bfloat16 ulp (2^-7 of the value) where
     it is rounded to bfloat16;
   - the beam-step kernel at W=5, B=64 (the eval's) on the eval model,
     float32 and bfloat16 bank and carry, about 30% finished lanes, once
     with t < min_len: flat ids equal except where the plain version's
     totals tie within 1e-4 (counted), scores within 1e-4, the carry as
     the decode step's.
   Times are CUDA-event medians of 2 x 20 calls after warm-up, taken in
   turns, with the weights packed once as the paths pack them (the
   decode step at G=1 too); the bound is computed from each call's
   shapes, and each time line gives the kernel's share of it (bound /
   time). The decode-step and beam-step kernels' device time a call is
   split by launch (q, attend, gates, cell, logits, merge) from
   torch.profiler over 10 more calls (``step_phases``). The attention
   kernel is timed at B=64, B=320 and M=1000 in bfloat16, in turns with
   its plain version, and by ``attention_phases``: its device time from
   torch.profiler over 10 calls (one launch a call), warm (the same
   inputs, which L2 holds) and cold (rotating through copies of the
   inputs that exceed twice the 50 MB L2), and the cold CUDA-event time;
   every call as the decoder makes it, on inputs that need gradients.
3. serve: CaptionService at msrvtt_xe_attention full width (seeded random
   weights, +2 on the EOS bias so caption lengths vary) answers 64 trace
   requests on the paged path and again on the dense-gather path; the
   launch counters, set to 0 just before, must show one kernel launch per
   stride on each; the two paths must agree exactly, and at least 95% of
   requests must agree on all lanes with the same requests served through
   the plain version on the card. Also reported: how many of the serve's
   counter-noise draws differ in any bit between the CPU and the card.
3b. serve_lifecycle: on the same model and burst, capacity 32, K=2, S=8,
   paged. Hot swap: a second version (the model with seeded noise on its
   output bias) published from the first completion's feedback; both
   versions serve, paged launches equal the (stride, live version) pairs
   counted at each stride, every request equals itself served alone by a
   fresh service under its pinned version (exact), and the old version is
   retired. Drain: SIGTERM from the feedback after the 16th completion;
   drained with reason "sigterm", a snapshot written, replayed by
   ``load_snapshot`` onto a fresh capacity-16 service grown to 32, and
   drained plus replayed results equal the undrained serve exactly.
   Grouped admission: ``admit_group=8`` on a float32 copy against solo
   admission (requests differing in any bit and the largest logprob
   difference reported; >= 95% with equal tokens on all lanes), and the
   bfloat16 service's fallback to 1. Policies: ``static_batch_serve`` at
   capacity 32 beside the continuous engine (requests/s, p50, p99). SLO:
   ``set_slo`` at twice the median solo latency, ``slo_snapshot``.
3c. serve_composite: the composite stride (decode_impl "xla") on the
   ``msrvtt_xe_attention`` model as the preset has it (decode_impl and
   attention_impl "xla", bfloat16 compute, full width) with phase 3's
   weights, on phase 3's burst (capacity 32, S=8, frame bucket 4). (a)
   K=2: no kernel launches, the lanes on the card, >= 95% of (request,
   lane) token rows equal to phase 3's kernel serve; requests/s, p50,
   p99. (b) ``min_len=3``: no EOS or PAD before a request's local step 3;
   8 requests each served alone at the same capacity, bitwise equal
   (``COMPOSITE_ALONE``), and decoded offline alone through
   ``fused_decode`` (B=1, the same counter noise): tokens equal
   (``COMPOSITE_OFFLINE_TOKENS``), logprobs within 1e-4, the bitwise
   share reported. (c) K=0: greedy rows equal to (a)'s lane 0 on >= 95%.
   (d) attention_impl "pallas": kernel 1 launches exactly strides x S x
   G times, >= 95% of rows equal to (a)'s. (e) ``rl.OnlineSCSTTrainer``
   (msrvtt_scst's K and reward, batches of 16) on a composite service of
   32 requests named after a seeded corpus's clips: at least one update
   and one publish swapped in, finite losses. No arm launches a stride
   kernel.
4. train: msrvtt_cst_consensus at full width with attention_impl and
   decode_impl "pallas" (seeded random weights with a unigram prior on the
   corpus words, see ``train_model``), on a seeded in-memory corpus of 64
   clips (4-28 frames, 5 template captions each): 3 XE steps (dropout 0.5,
   Adam, clip 5, guard on) with 30 attention launches per step, then 3 CST
   steps (K=5 rollouts, self-consensus baseline, CIDEr-D + 0.5 BLEU4) with
   a fresh optimizer at the RL rate: one decode-step launch per decode
   step and 30 attention launches per update. One XE step and one CST
   step are run again from the same state and seeds with the plain
   versions patched in: XE loss within 1e-3 relative; at least 95% of the
   (rollout, clip) token rows equal, with equal rewards where equal; the
   update on the same tokens within 1e-3 relative in rl_loss.
5. eval: Evaluator.evaluate (pipelined) at msrvtt_eval_beam5 with
   decode_impl "pallas" (beam 5, max_len 30, batch 64) over an in-memory
   split of 256 clips (4-28 frames, 20 template references each), the
   model fitted briefly first (``fitted_model``): one beam-step launch per
   beam step (counted at the search loop), at least 95% of clips with the
   caption the plain beam step gives on the card, all 8 metrics finite.
6. scst: msrvtt_scst (K=1, greedy baseline, CIDEr-D) with attention_impl
   and decode_impl "pallas" on the train corpus, from a model fitted
   briefly on it (``fitted_model``, as SCST starts from an XE model):
   3 steps, one dense
   stride-kernel launch per stride of the fused greedy-plus-rollout decode
   and 30 attention launches per update; against the plain versions: at
   least 95% of greedy and sampled rows equal, rl_loss on the same rows
   within 1e-3 relative and within one bfloat16 rounding (2^-8) of the
   loss's scale, the same sum over |advantage|: the greedy baseline's
   advantages take both signs and cancel in the loss, so an error
   relative to the loss itself can sit near its bound (H100 runs read
   5.79e-4, PERF.md), and the bfloat16 attention kernel and its
   plain version round at different places (the plain version rounds the
   scores and weights to bfloat16), which a fitted model's sharp logits
   carry into the logprobs.
6b. rl_decoupled: the decoupled actor/learner trainer
   (``rl.AsyncSCSTTrainer``) at msrvtt_cst_consensus width with
   attention_impl and decode_impl "pallas" (K=5, self-consensus baseline,
   CIDEr-D + 0.5 BLEU4), from the scst phase's fitted weights, over 6
   video-mode batches of 64 (60 train-corpus clips, 4 wrap-padded rows a
   batch). Gates: strict mode bitwise equal to the sync
   ``SCSTTrainer.train_epoch`` (params, every step's rl_loss and
   reward_mean), pipelined (sync, strict, strict, sync in turns, also
   each against its twin) and sequential, and depth 1 with bound 0
   strict without the flag; depth 3 with bound 1 (the counted run):
   the staleness ledger and drop count the JAX trainer gives for this
   schedule, one decode-step launch per decode step, recounts included
   (the sampler's steps counted at its loop), 30 attention launches per
   update, and a second run bitwise equal; a drain after 3 batches
   persists the ring through ``Trainer._seam_bytes`` / ``_load_seam``,
   the resume replays its tokens and equals the uninterrupted strict run
   bitwise. Reported: clips/s of strict-decoupled and sync epochs in
   turns, the depth-3 epoch's, the host-observed actor and learner
   occupancy, the wall.
6c. rl_online: online SCST from served traffic
   (``rl.OnlineSCSTTrainer``). The serve model (msrvtt_xe_attention
   width, decode_impl "pallas", S=8, paged, capacity 32, K=1) and a
   learner copy with attention_impl "pallas", both from the fitted
   weights; msrvtt_scst's RL config (greedy baseline, CIDEr-D, lr 2e-5)
   with online_batch_size 16, rollout_depth 2, staleness_bound 4,
   swap_every 1; 256 requests of a seeded Poisson trace (its seeds and
   order, served as a burst so that admission does not depend on the
   clock), each named after a train-corpus clip and carrying its frames.
   In turns: frozen, online (the counted run), online, frozen. Gates:
   requests in flight straddle at least 2 versions; every request
   replayed by a fresh service under its pinned version is bitwise
   equal; each request decoded offline alone through ``fused_decode``
   (the dense stride kernel, one launch per stride) under that version
   gives equal tokens on >= 95% of rows and logprobs within 1e-4 where
   equal; the second online run ends with bitwise-equal learner params
   and the same staleness ledger; updates, batches, drops, publishes and
   swaps agree with the counters; paged launches equal the (stride, live
   version) pairs and there are 30 attention launches per update.
   Reported: requests/s and p99, frozen and online; updates, publishes,
   swaps, the staleness histogram and the reward trend.
6d. resilience: one seeded ``resilience.chaos.FaultPlan`` an arm, each
   held to the JAX chaos test's gate, through the port's entry points at
   msrvtt_cst_consensus width with attention_impl and decode_impl
   "pallas", B=64, over the recipe corpus's 384 train clips in the
   port's files (6 batches an epoch; no validation):
   (1) ``preempt`` at ``xe.step`` visit 3: the trainer's SIGTERM handler
   saves mid-epoch, the ``resume="auto"`` run ends with params and every
   step's loss bitwise equal to the uninterrupted epoch, and the previous
   SIGTERM handler is back; (2) ``nan`` at ``xe.batch`` visit 2 under
   ``skip_batch``: the epoch completes 5 steps, the poisoned step leaves
   the params bitwise as they were, all finite; the same batch under
   ``train.debug_nans`` raises ``FloatingPointError`` naming a module, and
   a healthy ``debug_nans`` epoch equals the uninterrupted one bitwise;
   (3) ``io_error`` at ``reward.call`` visit 0 in an SCST epoch
   (msrvtt_scst's greedy baseline, the dense stride kernel): one
   ``reward_retry`` (``TransientIOError``), params bitwise those of the
   clean epoch; (4) ``partial_h2d`` at ``prefetch.h2d`` visit 1 and
   ``wedged_prefetch`` (1.0 s) at ``prefetch.stage`` visit 2 with a
   0.5 s stall watchdog, far above a batch's gather and staging: the
   clean prefetch stalls no time, and the faulted one stages every batch
   on the card bitwise equal to the clean one's, with one H2D retry and
   one stall (the clean run's longest wait is reported); (5)
   ``enospc_rotation`` at ``ckpt.state_written`` on the trained state's
   third ``step_*`` save: the oldest generation is reclaimed and the
   save lands; then a ``kill`` at ``ckpt.pre_replace``: the previous
   generation verifies and restores; (6) ``param_swap`` at
   ``serving.param_swap`` visit 0 on the serve phase's model and burst
   (capacity 32, paged): the publish from
   the first completion is refused, version 0 throughout, and the drained
   snapshot replayed on a fresh service plus the served requests equal a
   serve without the fault bitwise; (7) ``actor_preempt`` at
   ``rl.actor.step`` visit 1 of a decoupled CST epoch (depth 3, bound 1):
   one ``rl_actor_fallback_sync``, one finite step for every batch.
   Reported: each arm's wall time, ``plan.fired`` and launches; the
   resume's restore ms, a step save's ms and bytes with and without the
   ENOSPC reclaim, the restore after the kill, the drain, snapshot load
   and replay times.
6e. health: the strict peer-loss path (``train.health`` with 2 simulated
   hosts, the watchdog at 0.1 s, a 0.5 s timeout, 2 misses) at
   msrvtt_cst_consensus width with attention_impl and decode_impl
   "pallas", B=64, over the recipe corpus's 384 train clips (6 batches an
   epoch). (a) ``partial_preempt`` at ``xe.step`` visit 3: ``PeerLost``
   naming host 1, one ``peer_loss_drain`` event (phase ``xe``, batch 4), a
   ``step_*`` checkpoint whose manifest verifies, and a ``peer_loss``
   postmortem whose meta has ``lost == [1]``; (b) a straight XE + CST run
   (sequential RL, as the JAX test), then the same run losing host 1 at
   ``rl.step`` visit 2: ``PeerLost``, the drain at batch 3; a restart with
   ``resume="auto"`` and a fresh health directory ends with params and
   step bitwise those of the straight run; (c) a second ``HealthMonitor``
   (host 1) beats on its own thread and stops, no tombstone: the trainer's
   watchdog declares it lost by staleness within the window the interval,
   timeout and misses imply (``detection_bound_s``), and the XE epoch
   drains; (d) the serve model and burst (capacity 32, K=2, S=8, paged)
   under a started 2-host monitor, ``simulate_peer_loss(1)`` from the
   feedback after the 16th completion: drained with reason ``peer_loss``,
   a snapshot written, drained plus replayed equal to the undrained serve
   exactly, paged launches >= 1; (e) a ``proc1/`` bundle written beside
   (b)'s obs dir (its last RL step non-finite): ``obs.fleet.merge_bundles``
   gives procs [0, 1], victims [1] and the trip on proc 1, the rendering
   has ``[TRIP]``, and ``cli.obs_report --postmortem`` exits 0. Kernels 1,
   2 and 4 each launch in the phase. Reported: each arm's wall and
   launches, the detection latency (the peer's last beat to the
   ``peer_lost`` event) beside its bound, the drains' save ms, the
   restart's restore ms, the serve drain, snapshot load and replay times.
6f. syncs: the runtime cross-check of the port's lint (GL001, GL003,
   GL013), as ``pytest --sanitize`` is the JAX lint's. A burst of 16 of
   the serve phase's requests (capacity 32, K=2, S=8, paged, full
   width), one XE step of phase 4's model and one greedy-baseline SCST
   step of phase 6's, each under ``torch.cuda.set_sync_debug_mode
   ("warn")``, every synchronizing call recorded by the file and line
   that made it (``warnings.catch_warnings(record=True)``). Reported:
   the syncs per serve stride, per XE step and per SCST step, by site,
   and those of one stride of a composite serve of the same burst
   (reported, not gated, as the serve's).
   Gate: every site in the port's ``train/``, ``rl/``, ``decoding/`` or
   ``ops/`` (the kernels' wrappers, which those call each step) is a
   finding of ``python -m cst_captioning_tpu_torch.tools.graftlint``
   (new or in ``graftlint_torch.baseline``); the mode is off again
   after the phase.
6g. param_bf16: ``ModelConfig.param_dtype="bfloat16"`` at phase 4's
   model (msrvtt_cst_consensus full width, the kernels on, the train
   corpus's weights and clips). (a) At compute dtype bfloat16 and float32,
   a bf16-param model (the seeded float32 weights ``.to(bfloat16)``) and
   a float32-param model holding the same bf16-rounded values, bitwise
   equal on: the XE logits (kernel 1), the CST sampling decode (K=5,
   kernel 2), the SCST fused decode (K=1, kernel 3), 16 requests of the
   serve burst (capacity 32, K=2, S=8, kernel 4) and beam-5 of 8 clips
   (kernel 5); every kernel launched. (b) Kernels 1-5 against their
   plain versions on the bf16 model's packed weights (bfloat16), at
   phase 2's shapes and tolerances (bfloat16 banks). (c) Three XE steps
   and one CST step at bf16 params: finite, params and Adam moments
   bfloat16; one XE step
   (16 clips, dropout 0) on the card and by the port on the CPU from the
   same bf16 params, at each compute dtype, held by what the step
   computed (``bf16p_step_close``): the loss within 2^-10 and the grad
   norm within 2^-8 relative, and the Adam moments (after one step ``mu
   = 0.1 g``, ``nu = 0.001 g^2``) by ``moments_close``: each leaf's
   element errors within 2^-4 (mu) and 2^-3 (nu) of its largest value,
   each leaf's relative L2 distance within 2^-4 and 2^-3, the whole
   tree's within 2^-6 and 2^-5 (the CPU tests' bounds). Two controls must
   be refused by the same gate: the card's step on the first 8 clips, and
   the card's moments scaled by 1.05. The bitwise shares of params and
   moments are reported. (d) Parameter and Adam-moment bytes
   (numel x element size) exactly half the float32 state's; a save and
   restore of the bf16 state bitwise, both files' sizes reported. (e)
   Kernels 2-5 read the bf16 model's weight pack in bfloat16 and widen
   it in the kernel, as the TPU kernels do: at phase 2's shapes (serve
   capacity 32, K=2, S=8, dense and paged; SCST B=64, K=1; the decode
   step at G=5 and G=1; the beam step at W=5, B=64) each launched on the
   bf16 pack and on the float32 pack of the same values (the float32
   model's), outputs bitwise equal (tokens, logprobs, logits, carry,
   beam scores and flat ids); the bf16 pack exactly half the float32
   pack's bytes; kernels 2-5 launched on a bf16 pack on (a)'s and (c)'s
   paths (``bf16_pack_launches``, also in the kernels line). Also
   reported: each of those calls' CUDA-event ms (in turns, each pack
   beside the other) and device ms (``queued_device_ms``: 10 calls
   queued behind a sleep kernel) with each pack,
   ``torch.cuda.max_memory_allocated`` over one greedy decode of the 64
   clips by each model, ``stride_weights`` ms a pack from bf16 and
   float32 parameters (once a decode in training, once a version in
   serving), the phase's seconds.
7. profile: device time by kernel over one more serve, one more CST step
   and one beam-5 search of 64 clips, from torch.profiler, and the
   device's idle share.
8. recipe: the trainer and the CLIs from files. A template corpus in the
   port's feature format (``data.synthetic``: msrvtt modalities, 28
   frames, 200 words, 384 / 64 / 128 clips, 5 captions a clip, about
   123 MB of features) with its WXE weights and CIDEr df
   (``data.preprocess``), in a temporary directory; then, in process:
   ``cli.train`` at msrvtt_cst_consensus with attention_impl and
   decode_impl "pallas", 2 XE epochs and 1 CST epoch (30 attention
   launches per XE step and per update, one decode-step launch per CST
   decode step, one per greedy validation step at G=1, best and latest
   written, every validation CIDEr-D finite); a 1-epoch XE run resumed
   ("auto") to 2 epochs, and a resume from a mid-epoch
   ``ckpt_every_steps`` save alone, each against the uninterrupted run
   (the same video ids at every step, the same infos, per-step losses
   within 1e-3 relative); msrvtt_scst for one RL epoch from the XE best
   (one dense stride launch per stride, 30 attention launches per
   update); ``cli.eval`` at msrvtt_eval_beam5 on the XE best with the
   beam-step kernel (one launch per beam step, 8 finite metrics); one
   XE epoch of msvd_xe_meanpool with kernel 1 (kernel 1 at M=1 against
   its plain version); the first batch of every epoch, staged by the
   prefetch thread on its side stream, equal to a blocking copy; the
   device idle share of a pipelined and a sequential CST epoch from
   torch.profiler. One ``recipe`` line: clips/s by epoch, validation
   ms, checkpoint save and restore ms and bytes, the idle shares, the
   eval wall and CIDEr-D after XE and after CST.
8b. import: an MSR-VTT distribution (``videodatainfo.json``, 128 clips:
   96 train / 16 validate / 16 test, 20 template captions each, a
   directory of ``<video_id>.npy`` at resnet [28, 2048] and c3d [28, 500]
   float32) and an MSVD one (``video_corpus.csv`` with a German row a clip
   and ``youtube_mapping.txt``, 64 clips, resnet only, split 48 / 8 / 8)
   in a temporary directory; ``cli.import_msrvtt``, ``cli.import_msvd``
   and ``cli.preprocess`` in process; every output loads through
   ``CaptionDataset``; ``cli.train`` for one XE epoch at
   msrvtt_cst_consensus from the imported MSR-VTT directory with the
   kernels on (30 attention launches a step, one decode-step launch a
   greedy validation step); the ``best`` checkpoint (``ckpt.load_params``)
   published into a live ``CaptionService`` mid-serve of the test clips:
   requests admitted after the swap carry version 1. Wall times by step.
8c. obs: the observability subsystem at the recipe's width, on a fresh
   recipe corpus. ``cli.train`` at msrvtt_cst_consensus (kernels on) for
   one XE and one CST epoch with ``--obs``, ``--profile``,
   ``train.recorder_steps=16`` and ``train.anomaly``; ``cli.eval``
   (beam 5) with ``--obs``; ``cli.obs_report --json`` of each. Gates:
   coverage >= 0.90 with the setup, xe.step, rl.decode, rl.reward,
   rl.update, ckpt.save and eval rows; ``device.peak_flops`` the peak
   table's entry for this card and every MFU row in (0, 1]; the
   ``device.*`` memory gauges in (0, card memory]; the XE profile trace
   naming kernel 1 (``additive_attention_kernel``) and the CST one kernel
   2 (``step_attend``, ``step_logits``); the ring holding every step with
   finite losses, grad norms and update ratios; ``recorder.postmortem``
   bundle verified and rendered by ``cli.obs_report --postmortem``. Then
   eight XE epochs, obs off and obs with the recorder on in turns (off,
   on, on, off, twice): losses and final params bitwise equal, and the
   synchronizing CUDA calls of an epoch (``torch.cuda.set_sync_debug_mode
   ("warn")``) with obs on at most the recorder's flushes above obs off;
   clips/s of each and the ratio of the medians. The serve phase's
   64-request burst four times, obs off and on in turns (requests/s and
   the ratio of the medians), then once more with obs on: the funnel counters 64, ``serving.strides`` the
   counted paged launches, 64 latencies, the serving and SLO sections;
   and a drain after 16 completions whose postmortem bundle verifies.
   Prints the top host rows of the training and the serve reports, and
   what one span costs the host (``obs_emit_cost``).
8d. data_parallel: ``train/mesh.py``, ``train/multihost.py`` and
   ``parallel/comms.py`` through the port's Trainer and Evaluator at
   msrvtt_cst_consensus width with the kernels, global batch 64, over the
   recipe corpus's 384 train clips, dropout 0, once at float32 compute
   (the JAX data-parallel tests' setting) and once at bfloat16 (the
   presets'); each run: an XE epoch (6 steps) with its greedy
   validation, a CST epoch (K=5, self-consensus) and an SCST epoch
   (msrvtt_scst's greedy baseline, the stride kernel) each from the start
   weights (a 4-epoch XE fit of the seeded init, on one device), and the
   start weights' beam-5 evaluation of the 64 val clips. Besides, one CST
   update at lr 5e-2 (the rate the JAX tolerances were set for; the
   presets' RL rate of 2e-5 moves a parameter less than those
   tolerances) from the start weights on the first batch. (a) NCCL at
   world size 1 (a ``file://`` init in this process), against the same
   runs without a mesh. (b) two ranks on the one card over gloo (named
   explicitly; NCCL refuses two ranks on one device), this script run as
   ``--dp-rank`` children, 32 rows a rank, against arm (a): both ranks'
   params bitwise equal after each phase, ``proc1/`` holding
   ``dcn.collective`` spans, kernels 1, 2, 3 and 5 launched on each rank.
   The schedule's gates (``dp_gate``), in (a) and (b): per JAX leaf the
   displacement from the start within ``DP_DISP`` of the reference's, the
   XE losses within ``DP_LOSS``, every rollout row decoded from the
   start weights equal, the beam-5 captions and metrics equal; at
   float32 also the JAX tolerances with no element outside (params after
   XE rtol 1e-3 / atol 1e-5, after CST and SCST rtol 1e-2 / atol 2e-3)
   and >= 95% of the later rollout rows and of the validation captions
   equal. The update's gates (``dp_rate_close``): the reduced gradient
   (Adam's first moment) within ``DP_GRAD`` of its leaf's scale, the
   params within the JAX tolerance but where the reference's gradient is
   within that rounding of 0, the loss within 1e-5. (c) the same update
   at two ranks with bf16 on the wire against f32: the JAX bound 5e-3 on
   that footing, the loss within 1e-6. Planted faults (``dp_planted``:
   the smallest bucket zeroed, or split back one element off) must fail
   the update's gates, and a zeroed bucket in a bfloat16 XE epoch the
   ``DP_DISP`` gate. (d) bfloat16 compute: one SCST update (msrvtt_scst,
   K=1) at lr 5e-2 on the two ranks against arm (a)'s; the attention
   score vector's reduced gradient (``DP_BF16_LEAF``, the leaf whose
   displacement after the bfloat16 SCST epoch spreads nearest a lost
   leaf's) within ``DP_GRAD``'s bf16 bound of its largest element, and
   with that leaf's bucket zeroed it must read above it. Also: the
   ``comm.buckets`` / ``comm.bytes_on_wire``
   gauges equal to ``comms.ledger``, the NCCL version. Reported: each
   arm's wall and phase times, the per-rank step ms, the
   ``rl.update.allreduce`` spans, the CUDA-event ms of one update's
   all-reduce, the buckets and bytes on the wire and each rank's
   launches (arm (b)'s times are gloo through the host).
8e. rl_split: the actor/learner split across ranks
   (``rl.AsyncSCSTTrainer(mesh=...)``, ``parallel.submesh``) on the
   data_parallel phase's recipe corpus and start weights, B=64 global, 6
   video-mode batches, ``actor_fraction`` 0.5, Adam at lr 5e-2 (one update
   moves the tokens, so a stale version shows), attention_impl and
   decode_impl "pallas". The reference: the same epoch in this process on
   a mesh of 3 virtual ranks (the split's plan, faults, events and
   ledgers, every role here), itself bitwise equal to no mesh. (a) NCCL at
   world 1 (the shared plan): bitwise equal to no mesh. (b) three gloo
   ranks on the one card, this script as ``--dp-rank`` children: ranks 0
   and 1 actors, rank 2 the learner; at float32 and at bfloat16, depth 2
   / bound 1, depth 3 / bound 1 (the JAX drop ledger), ``actor_preempt``
   at batch 2 then ``host_rejoin`` at batch 4 (2 -> 1 -> 2 actors), two
   preempts (2 -> 1 -> the sync fallback), all at msrvtt_cst_consensus,
   and depth 2 / bound 1 at msrvtt_scst (kernel 3). Gates: the learner's
   scored token rows, the losses and rewards, every rank's params digest,
   the staleness ledger, the drops and the events equal the reference's;
   the fired faults; the occupancy alike on every rank; per rank, 30
   attention launches an update on the learner and none on the actors,
   one decode-step launch a counted decode step, decodes on the actors
   and none on the learner without drops. Planted faults must fail the
   gates: an actor that decodes with the previous parameter version, and
   a handoff that routes rows one rank off. Reported: each epoch's wall
   and clips/s beside the reference's (one card time-sliced between
   three processes: semantics, not speed), the broadcast's ms an update,
   the occupancy, each rank's launches.
8f. elastic: elastic training over real ranks (``train.elastic=
   "degraded"``, the Trainer's continuations, ``multihost.regroup``) on
   the data_parallel phase's corpus and start weights, at
   msrvtt_cst_consensus as that phase runs it (full width, kernels 1 and
   2, dropout 0, float32, B=64 global), the health phase's watchdog
   periods, two gloo ranks on the one card, host = rank, this script as
   ``--dp-rank`` children; two XE epochs, then two pipelined CST epochs.
   Beside the two ranks wait a restarted host 1 and a restarted host 0,
   each until its tombstone appears. (a) The parent SIGKILLs host 1 37 ms
   after its third XE step's event (mid-step); host 0 finds the loss
   (its monitor; its collective raised), drains, regroups at world 1 and
   goes on. (c) The restarted host 1 finds its tombstone and rejoins:
   ``mesh_regrow`` with hosts [0, 1] at generation 2. (b) The parent
   SIGKILLs host 0, rank 0, two CST steps after the regrow; host 1 writes
   the drain save (no seam: no update past the loss) and goes on as rank
   0 of generation 3. (d) The restarted host 0 announces itself and exits
   before the rendezvous: ``regrow_refused``. A degraded boundary waits
   0.3 s, so a restarted host arrives while the survivors still train.
   Gates: the events' hosts and generations, host 0's XE clock and the
   RL clock contiguous, and every stretch between two membership changes
   bitwise equal step by step (params and Adam moments, a fingerprint of
   their bits on the card) to a fresh run at its world resumed from the
   drain save it began at: (a) at world 1 to the regrow, (c) at world 2
   on both hosts to host 0's death (two more ranks), (b) and (d) at world
   1 to the end, through the refusal (the run without the rejoin). (e)
   msrvtt_scst (kernel 3 decodes): two ranks, one RL epoch, the parent
   SIGKILLs host 1 after the second SCST step; host 0's continuation
   bitwise as above. Planted faults, in one process with two simulated
   hosts and one XE epoch, must fail the stretch gate: a survivor that
   keeps its own state and bookkeeping instead of the drain save, and a
   regrow that takes the drain's position with the previous drain's
   parameters (the stale state a rejoiner would bring). Reported: the
   detection latency against the window, the rendezvous, regroup and
   restore ms of each continuation and of the rejoiner, the first step's
   ms on each new world, the outage wall (death to the first step on the
   new world; the regrow drain to the first step after it), each host's
   kernel launches.
8g. seq_parallel: sequence parallelism (``parallel/seq_parallel.py``,
   ``train.mesh.GridMesh``) on the data_parallel phase's corpus and start
   weights at msrvtt_cst_consensus width (V=9000, resnet 2048 + c3d 500,
   temporal attention, 28 frames: 14 a rank, E=H=512, A=256, max_len 30),
   attention_impl and decode_impl "xla" (the kernels' softmax is one
   device's; the JAX package refuses them with seq_devices > 1), B=64
   global, at float32 and at bfloat16 compute. The reference: one rank on
   the card, no mesh. Gloo ranks on the one card, this script as
   ``--dp-rank`` children: a (1 x 2) grid (one row of two) and a (2 x 2)
   grid, launched together. On each: the logits of the first caption-mode batch; one XE step
   at lr 5e-2 (Adam from zero moments); the fused greedy + K=5 rollout
   decode of the first video-mode batch; the SCST update at lr 5e-2 with
   chunks 1 and 5 on the reference's rollouts and seeded advantages;
   beam-5 over the 64 val clips; on (1 x 2) the greedy decode of 16 clips
   of 448 frames a modality (224 a rank, ragged masks). Gates: float32 at
   the CPU tests' tolerances where they apply (logits rtol 2e-5 / atol
   1e-5; the steps' loss 1e-5 relative; every token row and beam caption
   equal), each step's reduced gradient (Adam's first moment) within 1e-4
   of its leaf's largest element, and its params within rtol 1e-4 / atol
   1e-5 (``SP_STEP_TOL``) at every element but those whose difference
   Adam's first step makes of the leaf's measured gradient error (an
   element whose gradient lies near Adam's eps or within that error of
   0 moves by up to lr with the summation order: ``adam_step_gap``);
   bfloat16 at ``SP_BF16``, bounds from the card's readings; every rank's
   params equal after the XE step, every row's tokens equal; planted
   fault (a) (``seq_enter``'s backward as the identity) must fail the XE
   step's gates at both dtypes on both grids. The attention score vector
   (``DP_BF16_LEAF``, the leaf whose bfloat16 displacement after the CST
   epoch spreads nearest a lost leaf's) is held by its reduced gradient
   after the chunks-1 update (the steps' gradient bound of its dtype),
   and the same update with that leaf's row sum zeroed
   (``sp_zeroed_row_sum``) must read above it at both dtypes. Each rank warms a step up first; the times are of the next
   calls.
   Then an XE epoch (6 steps, dropout 0.5, greedy validation) and a CST
   epoch (K=5, self-consensus), each from the start weights: on two ranks
   the data-parallel run, and on the (2 x 2) grid against it, each grid
   rank against its data coordinate's rank (the same rows and dropout
   masks): float32 XE params rtol 2e-2 / atol 2e-3 and losses 1e-4
   relative (the JAX trainer test's), CST params at the JAX RL tolerance,
   the rollout rows decoded from the start weights equal and >= 95%
   over the epoch, >= 95% of validation captions equal; bfloat16 at
   ``SP_BF16``. The kernel launch counters must read 0 on every rank and
   in the reference. Reported: each step's ms on each grid and the
   one-rank's, each epoch's step ms, the grid's collectives (all-reduces
   and bytes a rank) per decode step, per XE step and per update (one
   card time-sliced between the ranks over gloo through the host:
   semantics, not the speed of N cards).
8h. model_parallel: model parallelism (``ops/decode_mp.py``, the ``('data',
   'mp')`` ``GridMesh``) with gloo ranks on the one card, this script as
   ``--dp-rank`` children. (a) The sharded-vocab decode of the serving
   model (msrvtt_xe_attention at full width, V=9000, seeded random
   weights) on an 'mp' row of 4 ranks and then of 2 (V_s 2250, 4500; one
   launch of four ranks, the second row of the (2 x 2) grid waiting), each
   rank running kernel 2 on its vocabulary slice: the stride at the
   serving shapes (capacity 32, K=2, S=8, every row's whole bank, no
   compaction) and beam-5 at B=64 (t=3; row 0 all finished at equal
   scores, an exact tie), float32 and bfloat16 banks. Gates: tokens and
   beam candidate ids bitwise equal to the replicated kernel-2 loop (the
   same decode on a row of one rank), logprobs and scores within 1e-5
   (``MP_LP_TOL``); against kernel 3 (the stride, no compaction) and
   kernel 5 equal except at the plain version's near-ties (``TIE_GAP``
   and ``compare_beam``'s TOL), logprobs and scores within TOL; kernel 2
   launched S times a stride and once a beam step on every rank; 8
   collectives a stride step; kernel 2 on each vocabulary slice bitwise
   its columns of the whole vocabulary (both banks, the stride's and the
   beam's shapes, mp 2 and 4). Planted faults at mp 2, each of which
   must fail its gate: the argmax merge given local indices, the
   embedding rows not summed, the top-W merge breaking ties to the
   higher flat id. (b) On the data_parallel phase's corpus, its train
   split cut to its first 192 clips (``MP_EPOCH_CLIPS``: epochs of 3
   steps, not 6, to keep the script inside its time limit), and start
   weights (``dp_schedule``, dropout 0.5, deterministic algorithms on):
   an XE epoch with greedy validation, a CST epoch, a split RL epoch
   and beam-5 of the 64 val clips at each compute dtype, on two
   data-parallel ranks and on the (2 x 2) grid (launched together), each
   grid rank against its data coordinate's rank; float32 bitwise (params, losses,
   rollouts, captions, metrics), bfloat16 reported; every row's replicas
   equal; one XE step with the mp-rank-1 replicas' loss scaled by 1 +
   1e-3 leaves each row equal through the row broadcast and, with the
   broadcast skipped (planted), apart. Reported: each rank's ms a stride
   and a beam step beside kernels 3 and 5 and the loop (event ms), the
   collectives and bytes a rank a step, kernel 2's launches, the
   epochs' step ms and the row broadcasts (one card time-sliced between
   the ranks: semantics, not the speed of N cards).
9. kernels: one JSON line with each kernel's TPU counterpart, launches on
   its paths (the recipe's, serve_lifecycle's, serve_composite's,
   param_bf16's, rl_decoupled's,
   rl_online's, resilience's, health's, import's, data_parallel's,
   rl_split's, elastic's, seq_parallel's and model_parallel's included;
   seq_parallel launches none by design),
   error, times and bound; for the
   decode and beam steps also
   their device time by launch, and the decode step's at G=1; for the
   attention its warm and cold device and event times at B=320, and the
   same at B=64 and M=1000, and its times at the composite stride's
   shape (``decode_b32``).

Each phase prints one JSON line; the card's nvidia-smi line and the kernels
line come before the last line, ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before it; without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from unittest import mock

import numpy as np
import torch

from cst_captioning_tpu_torch import obs as tobs
from cst_captioning_tpu_torch import ops
from cst_captioning_tpu_torch.ckpt import load_params as ckpt_load_params
from cst_captioning_tpu_torch.ckpt.checkpoint import load_state, save_state
from cst_captioning_tpu_torch.cli import eval as cli_eval
from cst_captioning_tpu_torch.cli import import_msrvtt as cli_import_msrvtt
from cst_captioning_tpu_torch.cli import import_msvd as cli_import_msvd
from cst_captioning_tpu_torch.cli import obs_report as cli_obs_report
from cst_captioning_tpu_torch.cli import preprocess as cli_preprocess
from cst_captioning_tpu_torch.cli import train as cli_train
from cst_captioning_tpu_torch.config import EOS_ID, PAD_ID
from cst_captioning_tpu_torch.convert import load_flax_params, random_flax_params
from cst_captioning_tpu_torch.data import (
    Batcher,
    CaptionDataset,
    Vocab,
    compute_cider_df,
    compute_consensus_weights,
    encode_label_row,
    make_synthetic_dataset,
)
from cst_captioning_tpu_torch.data import prefetch as prefetch_mod
from cst_captioning_tpu_torch.decoding import beam as decoding_beam
from cst_captioning_tpu_torch.decoding import beam_search
from cst_captioning_tpu_torch.decoding import common as decoding_common
from cst_captioning_tpu_torch.decoding import counter_gumbel_noise
from cst_captioning_tpu_torch.decoding import fused as decoding_fused
from cst_captioning_tpu_torch.decoding import sample as decoding_sample
from cst_captioning_tpu_torch.decoding.common import decode_depth
from cst_captioning_tpu_torch.eval import Evaluator
from cst_captioning_tpu_torch.eval import evaluator as evaluator_mod
from cst_captioning_tpu_torch.metrics import CorpusDF
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.obs import flops as obs_flops
from cst_captioning_tpu_torch.obs import recorder as obs_recorder
from cst_captioning_tpu_torch.obs import report as obs_report
from cst_captioning_tpu_torch.ops import attention as attention_ops
from cst_captioning_tpu_torch.ops import beam_step as beam_ops
from cst_captioning_tpu_torch.ops import build
from cst_captioning_tpu_torch.ops import decode_mp, decode_stride
from cst_captioning_tpu_torch.ops.attention import (
    additive_attention_f32,
    additive_attention_plain,
    fused_additive_attention,
)
from cst_captioning_tpu_torch.ops.beam_step import (
    beam_step_plain,
    beam_topk_plain,
    beam_workspace,
    fused_beam_step,
    fused_beam_step_,
)
from cst_captioning_tpu_torch.ops.decode_step import (
    decode_step_plain,
    fused_decode_step,
    fused_decode_step_,
    stack_carry,
    unstack_carry,
)
from cst_captioning_tpu_torch.parallel import CommConfig
from cst_captioning_tpu_torch.ops.decode_stride import (
    PACK_FIELDS,
    decode_stride_plain,
    fused_decode_stride,
    fused_decode_stride_paged,
    gather_pages,
    stride_weights,
)
from cst_captioning_tpu_torch.presets import get_experiment, get_preset
from cst_captioning_tpu_torch.rl import (
    AsyncSCSTTrainer,
    OnlineSCSTTrainer,
    RewardComputer,
    SCSTTrainer,
    rollout_seed,
)
from cst_captioning_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_xe_step,
    xe_row_weights,
)
from cst_captioning_tpu_torch.serving import (
    CaptionService,
    ClipRequest,
    TrafficSpec,
    load_snapshot,
    make_trace,
    static_batch_serve,
    synth_request_features,
)
from cst_captioning_tpu_torch.serving import engine
from cst_captioning_tpu_torch.train import trainer as trainer_mod

CAPACITY, K, S, FRAME_BUCKET = 32, 2, 8, 4
SERVE_DEVICE = "cuda"
N_REQUESTS = 64
TOL = 1e-4
BF16_ROUND = 2.0 ** -8   # one bfloat16 rounding, relative to the value
BF16_ULP = 2.0 ** -7     # one bfloat16 ulp, relative to the value
ROW_TOL = 1e-3           # of the row's largest value: sum order, tanh
TIE_GAP = 1e-3
REL_TOL = 1e-3           # kernel vs plain, end to end through a step
AGREE = 0.95             # share of token rows that must agree
TRAIN_B, XE_STEPS, CST_STEPS, SCST_STEPS = 64, 3, 3, 3
BEAM_W = 5               # msrvtt_eval_beam5's beam
EVAL_CLIPS, EVAL_B, EVAL_REFS = 256, 64, 20
FIT_STEPS, FIT_LR = 100, 1e-2   # the eval model's short XE fit
# H100 SXM data sheet: float32
# outside the tensor cores, and HBM3 bandwidth, at the 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
CSRC = "cst_captioning_tpu_torch/ops/csrc/"
# the step kernels' launches by kernel name (csrc/step.cuh, beam_step.cu)
STEP_LAUNCHES = {"step_q_gemm": "q", "step_attend": "attend",
                 "step_gates_gemm": "gates", "step_cell": "cell",
                 "step_logits": "logits", "beam_merge": "merge"}
KERNELS = ("fused_decode_stride", "fused_decode_stride_paged")
SOURCE = {
    "fused_additive_attention": CSRC + "additive_attention.cu",
    "fused_decode_step": CSRC + "decode_step.cu",
    "fused_decode_stride": CSRC + "decode_stride.cu",
    "fused_decode_stride_paged": CSRC + "decode_stride.cu",
    "fused_beam_step": CSRC + "beam_step.cu",
}
REPLACES = {
    "fused_additive_attention": "cst_captioning_tpu/ops/attention_pallas.py:169",
    "fused_decode_step": "cst_captioning_tpu/ops/decode_pallas.py:358",
    "fused_decode_stride": "cst_captioning_tpu/ops/decode_pallas.py:839",
    "fused_decode_stride_paged": "cst_captioning_tpu/ops/decode_pallas.py:1214",
    "fused_beam_step": "cst_captioning_tpu/ops/decode_pallas.py:1643",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def model_config():
    return dataclasses.replace(get_preset("msrvtt_xe_attention").model,
                               decode_impl="pallas", decode_stride=S)


def make_model(dev):
    cfg = model_config()
    model = CaptionModel(cfg, device=dev)
    return load_flax_params(model, random_flax_params(cfg, seed=0,
                                                      eos_bias=2.0)).eval()


# ---- phase 2: kernels against their plain versions ------------------------


def stride_inputs(model, dev, bf16: bool, seed: int = 1, B: int = CAPACITY,
                  K: int = K):
    """Serving-shaped stride inputs (or, with B=64 and K=1, the SCST
    decode's): B rows of ragged clips encoded by the model, some rows
    finished, a compaction prefix of B - 4, pages of 8 slots scattered over
    a pool in random order."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    G, F = 1 + K, cfg.max_frames
    frames = rng.integers(1, F + 1, size=B)
    feats = {n: torch.from_numpy(rng.normal(size=(B, F, d)).astype(np.float32)
                                 ).to(dev) for n, d in cfg.modalities}
    mask = torch.from_numpy(
        (np.arange(F)[None] < frames[:, None]).astype(np.float32)).to(dev)
    with torch.no_grad():
        enc = model.encode(feats, {n: mask for n, _ in cfg.modalities})
    bank_dtype = torch.bfloat16 if bf16 else torch.float32
    mem = enc.memory.to(bank_dtype)
    proj = enc.memory_proj.to(bank_dtype)
    M = mem.shape[1]
    lens = torch.from_numpy(rng.integers(1, M + 1, size=B).astype(np.int32))
    # f32 carry in both cases, so the carry is compared before rounding
    carry = tuple((c.float()[None].expand(G, -1, -1).contiguous(),
                   h.float()[None].expand(G, -1, -1).contiguous())
                  for c, h in enc.carry)
    token = torch.from_numpy(
        rng.integers(3, cfg.vocab_size, size=(G, B)).astype(np.int32)).to(dev)
    n_active = B - 4
    finished = torch.zeros((G, B), dtype=torch.bool)
    finished[:, n_active:] = True
    finished[:, 3::7] = True
    finished[G - 1, 5] = True
    noise = counter_gumbel_noise(
        torch.arange(B, device=dev) + 100,
        torch.arange(S, device=dev)[:, None].expand(S, B), K, cfg.vocab_size)
    # pages: P = n_mod * bucket slots, width = M / P, random pool order
    P = len(cfg.modalities) * FRAME_BUCKET
    width = -(-M // P)
    n_pages = B * width
    order = torch.from_numpy(rng.permutation(n_pages) + 1)
    table = order.reshape(B, width).to(torch.int32)
    pad = width * P - M
    pools = []
    for x in (mem, proj, enc.memory_mask.float()):
        xp = torch.nn.functional.pad(x, (0, 0, 0, pad) if x.ndim == 3
                                     else (0, pad))
        pool = torch.zeros((n_pages + 1, P) + tuple(x.shape[2:]),
                           dtype=x.dtype, device=dev)
        pool[order.to(dev)] = xp.reshape((n_pages, P) + tuple(x.shape[2:]))
        pools.append(pool)
    return dict(
        w=stride_weights(model.cell),  # packed once, as a serve or decode does
        carry=carry, token=token, finished=finished.to(dev),
        dense=(mem, proj, enc.memory_mask.float()),
        paged=(*pools, table.to(dev)), noise=noise, t0=0, n_active=n_active,
        mem_lens=lens.to(dev),
    )


def run_kernel(name, model, x):
    fn = fused_decode_stride_paged if name.endswith("paged") else \
        fused_decode_stride
    bank = x["paged"] if name.endswith("paged") else x["dense"]
    return fn(model.cell, x["carry"], x["token"], x["finished"], *bank,
              x["noise"], x["t0"], x["n_active"], steps=S, temperature=1.0,
              min_len=0, mem_lens=x["mem_lens"], weights=x["w"])


def run_plain(name, model, x, return_gap=False):
    bank = x["dense"]
    if name.endswith("paged"):
        bank = gather_pages(*x["paged"])
    return decode_stride_plain(
        x["w"], x["carry"], x["token"], x["finished"],
        *bank, x["noise"], x["t0"], x["n_active"], steps=S, temperature=1.0,
        min_len=0, mem_lens=x["mem_lens"], return_gap=return_gap)


def compare(name, model, x) -> dict:
    (kc, ktok, klp) = run_kernel(name, model, x)
    (pc, ptok, plp, gap) = run_plain(name, model, x, return_gap=True)
    torch.cuda.synchronize()
    ktok, ptok = ktok.cpu(), ptok.cpu()
    klp, plp, gap = klp.cpu(), plp.cpu(), gap.cpu()
    diff = ktok != ptok                                   # [S, G, B]
    diverged = diff.any(dim=0)                            # [G, B]
    first = diff.int().argmax(dim=0)                      # [G, B]
    near_ties = 0
    for g, b in diverged.nonzero().tolist():
        s = int(first[g, b])
        check(float(gap[s, g, b]) <= TIE_GAP,
              f"{name}: lane {g} row {b} step {s} diverges with plain-version "
              f"top-2 gap {float(gap[s, g, b]):.3e} > {TIE_GAP}")
        near_ties += 1
    # logprobs up to each row's first divergence; carry of rows live at the
    # end that never diverged
    steps = torch.arange(S)[:, None, None]
    upto = ~diverged[None] | (steps < first[None])
    lp_err = float((klp - plp).abs()[upto].max())
    check(lp_err <= TOL, f"{name}: logprob error {lp_err:.3e} > {TOL}")
    fin_end = x["finished"].cpu() | (ktok == EOS_ID).any(dim=0)
    live = ~fin_end & ~diverged
    check(bool(live.any()), f"{name}: no live row to compare the carry on")
    c_err = 0.0
    for (kc_, kh), (pc_, ph) in zip(kc, pc):
        for a, b in ((kc_, pc_), (kh, ph)):
            a, b = a.float().cpu()[live], b.float().cpu()[live]
            err = (a - b).abs()
            check(bool((err <= TOL + TOL * b.abs()).all()),
                  f"{name}: carry error {float(err.max()):.3e}")
            c_err = max(c_err, float(err.max()))
    check(bool((ktok[:, x["finished"].cpu()] == PAD_ID).all()),
          f"{name}: a finished row emitted a token")
    return {"tokens_equal": int((~diverged).sum()),
            "rows": int(diverged.numel()), "near_ties": near_ties,
            "max_abs_err": max(lp_err, c_err)}


def event_times(fn, reps=20, warmup=3) -> list[float]:
    """CUDA-event times (ms) of ``reps`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


STRIDE_PHASES = ("start", "init", "q", "attend", "gates", "cell", "logits",
                 "end")


def stride_phases(name, model, x) -> dict:
    """Device ms by phase of one stride launch on ``x`` (after a warm-up),
    from the kernel's own timeline: block 0's %globaltimer as it leaves
    each grid barrier, summed over the steps by phase."""
    dense = not name.endswith("paged")
    bank = x["dense"] if dense else x["paged"][:3]
    table = None if dense else x["paged"][3]
    slots, width = (bank[0].shape[1], 1) if dense else (
        bank[0].shape[1], table.shape[1])
    L = model.cfg.num_layers
    tl = torch.zeros(decode_stride.timeline_len(S, L), dtype=torch.int64,
                     device=bank[0].device)
    args = ("decode_stride_dense" if dense else "decode_stride_paged",
            x["w"], x["carry"], x["token"],
            x["finished"], *bank, table, slots, width, x["noise"], x["t0"],
            x["n_active"], S, 1.0, 0, x["mem_lens"])
    decode_stride._launch(*args)
    decode_stride._launch(*args, timeline=tl)
    torch.cuda.synchronize()
    ms = dict.fromkeys(STRIDE_PHASES[1:], 0.0)
    prev = None
    for code, t in tl.view(-1, 2).cpu().tolist():
        if t == 0:
            break
        if prev is not None:
            ms[STRIDE_PHASES[code]] += (t - prev) / 1e6
        prev = t
    return {**ms, "total": sum(ms.values())}


def smi_query(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def bound_ms(name, model, x, tokens) -> tuple[float, str]:
    """Least time for this call: bytes each input read once and each output
    written once, or float32 operations of the (row, lane, step)s that this
    run's data steps, whichever is larger."""
    cfg = model.cfg
    w = stride_weights(model.cell)
    E, H, A, V = cfg.d_embed, cfg.d_hidden, cfg.d_att, cfg.vocab_size
    L = cfg.num_layers
    lens = x["mem_lens"].clamp(min=1).cpu()
    live = tokens.cpu() != PAD_ID                         # [S, G, B] stepped
    n_steps = int(live.sum())
    slots = int(lens[None, None, :].expand_as(live)[live].sum())
    # q, LSTM gates, output projection: 2 ops per weight; attention per
    # slot: A adds, tanh, A multiply-adds, E multiply-adds for the context
    per_step = 2 * (H * A + (2 * E) * 4 * H + (L - 1) * H * 4 * H
                    + L * H * 4 * H + H * V) + 10 * L * H + 6 * V
    ops = n_steps * per_step + slots * (4 * A + 2 * E)
    nbytes = sum(t.numel() * t.element_size() for t in (
        w.wq, w.bq, w.v, w.wx, w.wh, w.bg, w.wo, w.bo, w.embt))
    # the bank slots of rows that step at least once
    rows = live.any(dim=0).any(dim=0)
    bank = x["dense"] if not name.endswith("paged") else gather_pages(
        *x["paged"])
    for t in bank:
        nbytes += int(lens[rows].sum()) * t[0, 0].numel() * t.element_size()
    nbytes += int(live[:, 1:].sum()) * V * 4          # noise of sampled steps
    nbytes += sum(2 * t.numel() * 4 for layer in x["carry"] for t in layer)
    G, B = tokens.shape[1:]
    nbytes += 2 * tokens.numel() * 4 + (2 * G * B + B) * 4
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def noise_mismatches(dev) -> tuple[int, int]:
    """Counter-noise draws at the serving shapes, made on the CPU and on
    the card: (draws, draws whose bits differ)."""
    g = torch.Generator().manual_seed(0)
    seeds = torch.randint(0, 2**31 - 1, (CAPACITY,), generator=g)
    ts = (torch.arange(S)[:, None]
          + torch.randint(0, 30, (CAPACITY,), generator=g)[None])
    cpu = counter_gumbel_noise(seeds, ts, K, model_config().vocab_size)
    gpu = counter_gumbel_noise(seeds.to(dev), ts.to(dev), K,
                               model_config().vocab_size).cpu()
    return cpu.numel(), int((cpu != gpu).sum())


# ---- phase 3: serving -------------------------------------------------------


def requests(cfg):
    trace = make_trace(TrafficSpec(num_requests=N_REQUESTS,
                                   frame_choices=(4, 12, 28)))
    out = []
    for item in trace.items:
        feats, masks = synth_request_features(item, cfg.modalities)
        # a burst: every request arrives at t=0, so latency is the time
        # from the start of serving to the request's completion
        out.append(ClipRequest(item.req_id, feats, masks, seed=item.seed))
    return out


def service(model, **kw):
    kw = {"num_rollouts": K, **kw}
    return CaptionService(model, capacity=CAPACITY, stride=S,
                          frame_bucket=FRAME_BUCKET, device=SERVE_DEVICE, **kw)


def plain_paged(cell, carry, token, finished, mem_pool, proj_pool, mask_pool,
                table, noise, t0, n_active, *, steps, temperature, min_len,
                num_layers, mem_lens, weights=None):
    """The paged stride through the plain version, on the card."""
    del num_layers
    return decode_stride_plain(
        weights if weights is not None else stride_weights(cell), carry,
        token, finished,
        *gather_pages(mem_pool, proj_pool, mask_pool, table), noise, t0,
        n_active, steps=steps, temperature=temperature, min_len=min_len,
        mem_lens=mem_lens)


def serve_timed(svc, reqs, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = svc.serve(reqs, **kw)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t


def profile_serve(model, reqs) -> dict:
    """Device time by kernel over one serve, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    svc = service(model)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        svc.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return device_breakdown(prof, wall_ms)


def check_results(rep, cfg) -> None:
    check(rep.completed == N_REQUESTS, f"{rep.completed} of {N_REQUESTS} "
          "requests completed")
    for rid, res in rep.results.items():
        check(res.tokens.shape == (1 + K, cfg.max_len), f"{rid} tokens shape")
        check(bool(np.isfinite(res.logprobs).all()), f"{rid} logprobs finite")
        check(bool((res.logprobs <= 0).all()), f"{rid} logprobs <= 0")
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
              f"{rid} token ids in range")
        check(0 <= res.best_lane <= K, f"{rid} best lane")


# ---- the training model, corpus and kernels --------------------------------


def train_config():
    """msrvtt_cst_consensus with the attention and decode-step kernels."""
    exp = get_experiment("msrvtt_cst_consensus")
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, attention_impl="pallas", decode_impl="pallas"))


def make_corpus(mc, n_clips: int, n_refs: int, seed: int) -> dict:
    """``n_clips`` clips of 4-28 random-feature frames (numpy), each with
    ``n_refs`` template captions "<det> <subject> <verb> <det> <object>
    [in the <place>]" over the vocab's words; a clip keeps its subject,
    object and place and varies its determiners and three verbs, so its
    references agree."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(mc.vocab_size - 4)]
    vocab = Vocab.from_corpus_words(words)
    F = mc.max_frames
    frames = rng.integers(4, F + 1, size=n_clips)
    feats = {n: rng.normal(size=(n_clips, F, d)).astype(np.float32)
             for n, d in mc.modalities}
    mask = (np.arange(F)[None] < frames[:, None]).astype(np.float32)
    dets, subjects, verbs = words[0:4], words[10:60], words[60:110]
    objects, places, (w_in, w_the) = words[110:160], words[160:200], words[200:202]
    gts, caption_ids = {}, []
    for b in range(n_clips):
        subj, obj, place = (rng.choice(x) for x in (subjects, objects, places))
        vs = rng.choice(verbs, 3, replace=False)
        caps = []
        for j in range(n_refs):
            toks = [rng.choice(dets), subj, rng.choice(vs), rng.choice(dets),
                    obj] + ([w_in, w_the, place] if j % 2 == 0 else [])
            caps.append(" ".join(toks))
        gts[f"clip{b:03d}"] = caps
        caption_ids.append([vocab.encode(c.split()) for c in caps])
    used = sorted({w for caps in gts.values() for c in caps for w in c.split()})
    return dict(feats=feats, mask=mask, vocab=vocab, gts=gts, vids=list(gts),
                caption_ids=caption_ids, words=used)


def on_device(c: dict, mc, dev) -> dict:
    """The corpus with its features and frame masks as tensors on ``dev``
    (``feats``, ``masks``: name -> [n, F, D] / [n, F])."""
    mask = torch.from_numpy(c["mask"]).to(dev)
    return {**c, "feats": {n: torch.from_numpy(x).to(dev)
                           for n, x in c["feats"].items()},
            "masks": {n: mask for n, _ in mc.modalities}}


def train_corpus(cfg, dev, seed=0) -> dict:
    """The train phase's 64 clips with 5 references each, on the card."""
    return on_device(make_corpus(cfg.model, TRAIN_B, 5, seed), cfg.model, dev)


def train_tree(mc, corpus, eos_bias: float = 7.5) -> dict:
    """Seeded random weights (a flax tree, float32) with a unigram prior
    in the output bias: +4 on the corpus's words and ``eos_bias`` on
    EOS."""
    tree = random_flax_params(mc, seed=0, eos_bias=eos_bias)
    bias = tree["params"]["cell"]["out_proj"]["bias"]
    bias[np.asarray(corpus["vocab"].encode(corpus["words"]))] += np.float32(4.0)
    return tree


def train_model(cfg, corpus, dev, eos_bias: float = 7.5):
    """``train_tree``'s weights: +7.5 on EOS, so that rollouts use the
    corpus's words and end after about ten tokens, as a model past its
    first XE epochs would (no trained checkpoint is in the repo)."""
    return load_flax_params(CaptionModel(cfg.model, device=dev),
                            train_tree(cfg.model, corpus, eos_bias))


def xe_batch(cfg, corpus, step: int, dev):
    """The XE batch of ``step``: each clip's caption ``step % 5``, every
    row valid with consensus weight 1, weighted as ``cfg.train.loss``
    says."""
    rows = [encode_label_row(ids[step % len(ids)], cfg.model.max_len)
            for ids in corpus["caption_ids"]]
    labels = torch.from_numpy(np.stack([r[0] for r in rows])).long().to(dev)
    mask = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
    ones = torch.ones(TRAIN_B, device=dev)
    return (corpus["feats"], corpus["masks"], labels, mask,
            xe_row_weights(cfg.train.loss, ones, ones))


def attention_inputs(model, corpus, dtype, rows: int):
    """The attention's inputs at a training shape: the XE step's (64 rows)
    or the REINFORCE update's (320 rows: the bank tiled over the 5
    rollouts), from the model's encoder and initial query."""
    with torch.no_grad():
        enc = model.encode(corpus["feats"], corpus["masks"])
        att = model.cell.attention
        q = att.query_proj(enc.carry[-1][1])
        reps = rows // TRAIN_B
        tile = lambda x: x.repeat((reps,) + (1,) * (x.ndim - 1))  # noqa: E731
        return (tile(q).to(dtype), att.score.detach().to(dtype),
                tile(enc.memory).to(dtype), tile(enc.memory_proj).to(dtype),
                tile(enc.memory_mask).contiguous())


def long_attention_inputs(model, dtype, M=1000, seed=2):
    """A long bank: M slots, ragged masks, row 3 fully masked."""
    cfg = model.cfg
    dev = model.device
    g = torch.Generator().manual_seed(seed)
    B, A, E = TRAIN_B, cfg.d_att, cfg.d_embed
    q = torch.randn(B, A, generator=g)
    mem = torch.tanh(torch.randn(B, M, E, generator=g))
    proj = torch.randn(B, M, A, generator=g)
    lens = torch.randint(1, M + 1, (B, 1), generator=g)
    mask = (torch.arange(M)[None] < lens).float()
    mask[3] = 0.0
    return (q.to(dev, dtype), model.cell.attention.score.detach().to(dtype),
            mem.to(dev, dtype), proj.to(dev, dtype), mask.to(dev))


def compare_attention(x) -> dict:
    """float32: against the plain version within TOL. bfloat16: against the
    kernel's own numerics in float32 (``additive_attention_f32``), within
    the output's one rounding (2^-8 of the value) plus ROW_TOL of the row's
    largest value; the plain version, which also rounds the scores and the
    weights, is reported beside it."""
    out = fused_additive_attention(*x)
    plain = additive_attention_plain(*x)
    torch.cuda.synchronize()
    if out.dtype == torch.float32:
        ref = plain
        limit = TOL + TOL * ref.abs()
    else:
        ref = additive_attention_f32(*x)
        limit = BF16_ROUND * ref.abs() \
            + ROW_TOL * ref.abs().amax(dim=-1, keepdim=True)
    err = (out.float() - ref).abs()
    check(bool((err <= limit).all()),
          f"attention ({out.dtype}): error {float(err.max()):.3e} over its "
          f"limit by {float((err - limit).max()):.3e}")
    # the gradient through the autograd rule equals the plain version's
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)
                    ).to(out.device)
    a = [t.clone().requires_grad_() for t in x[:4]]
    b = [t.clone().requires_grad_() for t in x[:4]]
    ga = torch.autograd.grad((fused_additive_attention(*a, x[4]).float()
                              * g).sum(), a)
    gb = torch.autograd.grad((additive_attention_plain(*b, x[4]).float()
                              * g).sum(), b)
    g_err = max(float((p.float() - q.float()).abs().max())
                for p, q in zip(ga, gb))
    check(g_err <= TOL, f"attention gradient error {g_err:.3e}")
    return {"max_abs_err": float(err.max()),
            "max_err_over_row_max": float(
                (err / ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
                 ).max()),
            "plain_max_abs_err": float((out.float() - plain.float()).abs().max()),
            "grad_max_abs_err": g_err}


def attention_bound(x) -> tuple[float, str]:
    """Bytes: every input once and the [B, E] output; operations: per
    slot the A-wide add, tanh and multiply-add and the E-wide weighted
    sum, in float32."""
    q, v, mem, proj, mask = x
    B, M, E = mem.shape
    A = q.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in x) \
        + B * E * mem.element_size()
    ops = B * M * (4 * A + 2 * E)
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


ATT_SHAPES = {"b64": "xe_b64", "b320": "update_b320", "m1000": "long_m1000"}
L2_BYTES = 50e6          # the H100's L2 cache


def check_attention(tmodel, corpus, tcfg) -> tuple[dict, float]:
    """Kernel 1 against its plain version at the XE step's B=64, the
    update's B=320 and M=1000, float32 and bfloat16, one kernel_check
    line each -> (the inputs by (shape, dtype), the largest error)."""
    att, worst = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, x in (
                ("xe_b64", attention_inputs(tmodel, corpus, dtype, TRAIN_B)),
                ("update_b320", attention_inputs(
                    tmodel, corpus, dtype, TRAIN_B * tcfg.rl.num_rollouts)),
                ("long_m1000", long_attention_inputs(tmodel, dtype))):
            res = compare_attention(x)
            emit({"phase": "kernel_check", "kernel": "fused_additive_attention",
                  "shape": label, "rows": x[0].shape[0],
                  "slots": x[2].shape[1], "dtype": str(dtype)[6:], **res})
            worst = max(worst, res["max_abs_err"])
            att[label, dtype] = x
    return att, worst


def cold_copies(x, total=2 * L2_BYTES) -> list:
    """Copies of the inputs ``x`` whose bytes together exceed ``total``: a
    call that rotates through them finds its inputs out of L2."""
    nbytes = sum(t.numel() * t.element_size() for t in x)
    return [tuple(t.clone() for t in x)
            for _ in range(int(total // nbytes) + 2)]


PROFILE_TRIES = 3   # whole traces taken before a launch count is judged


def profile_calls(fn, reps: int, complete) -> list:
    """torch.profiler's ``key_averages()`` over ``reps`` calls of ``fn``
    after a warm-up, traced again (at most PROFILE_TRIES times in all)
    while ``complete(events)`` says the trace missed launches: on the
    card the tracer has dropped some or all of a trace's kernel records
    (0 to 3 of 10 calls' kernels, in a whole run late or early). The
    caller then checks the last trace's counts."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if complete(events):
            break
        print(f"chip_smoke: torch.profiler missed launches in trace {i + 1}"
              f" of {PROFILE_TRIES}", file=sys.stderr, flush=True)
    return events


def attention_device_ms(fn, reps: int = 10) -> float:
    """Device ms a call of ``fn`` spends in the attention kernel, from
    torch.profiler over ``reps`` calls after a warm-up (``profile_calls``);
    the kernel must appear once a call."""
    def seen(events):
        ms, count = 0.0, 0
        for e in events:
            if str(e.device_type).endswith("CUDA") \
                    and "additive_attention_kernel" in e.key:
                ms += e.self_device_time_total / 1e3
                count += e.count
        return ms, count

    ms, count = seen(profile_calls(fn, reps,
                                   lambda ev: seen(ev)[1] == reps))
    check(count == reps, f"attention launches seen by the profiler {count}, "
          f"expected {reps}")
    return ms / reps


def as_decoder_inputs(x) -> tuple:
    """``x`` as the teacher-forced decoder passes them: q, v, memory and
    memory_proj need gradients (the query and score layers' outputs and
    the encoder's), so a call goes through the autograd Function."""
    return tuple(t.detach().requires_grad_(i < 4) for i, t in enumerate(x))


def attention_phases(x) -> dict:
    """Kernel 1 on ``x`` by device time, warm (the same inputs again: L2
    holds them up to B=320) and cold (rotating through ``cold_copies``),
    and by cold CUDA-event time (median of 40 calls)."""
    copies = [as_decoder_inputs(c) for c in cold_copies(x)]
    it = itertools.cycle(copies)
    cold = lambda: fused_additive_attention(*next(it))  # noqa: E731
    return {"device_ms": attention_device_ms(
                lambda: fused_additive_attention(*x)),
            "cold_device_ms": attention_device_ms(cold),
            "cold_ms": float(np.median(event_times(cold, reps=40))),
            "cold_copies": len(copies)}


def time_attention(att: dict, smi: str) -> dict:
    """Kernel 1 at the bfloat16 shapes, on ``as_decoder_inputs``: CUDA-event
    medians in turns with the plain version (warm), ``attention_phases``,
    the bound and the shares (bound over each time; the warm ones can pass
    1, since L2 holds the inputs), one attention_phases line each ->
    {shape: dict}."""
    xs = {k: as_decoder_inputs(att[label, torch.bfloat16])
          for k, label in ATT_SHAPES.items()}
    times = time_in_turns({
        k: (lambda x=x: fused_additive_attention(*x),
            lambda x=x: additive_attention_plain(*x)) for k, x in xs.items()})
    clocks = smi_query("clocks.sm,power.draw")
    res = {}
    for k, x in xs.items():
        bnd, by = attention_bound(x)
        ph = attention_phases(x)
        ms, plain_ms = times[k]
        res[k] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                  "bound_by": by, **ph, "share": bnd / ms,
                  "device_share": bnd / ph["device_ms"],
                  "cold_share": bnd / ph["cold_ms"],
                  "cold_device_share": bnd / ph["cold_device_ms"]}
        emit({"phase": "attention_phases", "kernel": "fused_additive_attention",
              "shape": k, "rows": x[0].shape[0], "slots": x[2].shape[1],
              **res[k], "clocks_sm_power_draw": clocks, "nvidia_smi": smi})
    return res


def decode_attention(model, smi: str) -> dict:
    """Kernel 1 at the composite stride's shape: a capacity's rows, one
    query each (the top layer's carry through ``query_proj``), over the
    dense bank's 56 slots, bfloat16 as the serving model computes, on
    inputs that need no gradient (the serve runs under no_grad): checked
    against its plain version (a kernel_check line), CUDA-event medians in
    turns with the plain version, device time from torch.profiler, the
    bound (a kernel_time line) -> the kernels line's ``decode_b32``."""
    dev = model.device
    x = stride_inputs(model, dev, True)
    att = model.cell.attention
    bf = torch.bfloat16
    with torch.no_grad():
        q = att.query_proj(x["carry"][-1][1][0].to(bf)).contiguous()
        xs = (q, att.score.detach().to(bf), x["dense"][0].contiguous(),
              x["dense"][1].contiguous(), x["dense"][2].contiguous())
    res = compare_attention(xs)
    emit({"phase": "kernel_check", "kernel": "fused_additive_attention",
          "shape": "decode_b32", "rows": q.shape[0],
          "slots": xs[2].shape[1], "dtype": "bfloat16", **res})
    with torch.no_grad():
        ms, plain_ms = time_in_turns({"decode_b32": (
            lambda: fused_additive_attention(*xs),
            lambda: additive_attention_plain(*xs))})["decode_b32"]
        device_ms = attention_device_ms(
            lambda: fused_additive_attention(*xs))
    bnd, by = attention_bound(xs)
    n_e, passes = attention_ops.attention_split(
        q.shape[0], xs[2].shape[2], xs[2].element_size(),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    line = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "share": bnd / ms, "device_ms": device_ms,
            "device_share": bnd / device_ms, "n_e": n_e, "passes": passes,
            "max_abs_err": res["max_abs_err"]}
    emit({"phase": "kernel_time", "kernel": "fused_additive_attention",
          "shape": "decode_b32", "rows": q.shape[0],
          "slots": xs[2].shape[1], **line,
          "clocks_sm_power_draw": smi_query("clocks.sm,power.draw"),
          "nvidia_smi": smi})
    return line


def step_inputs(model, corpus, bf16: bool, seed=3, G=None) -> dict:
    """The decode step's inputs at the rollout's shapes: G=5 lanes (or
    ``G``: 1 is greedy decoding's) of the 64 clips' encoder output, a
    perturbed carry and random tokens. With ``bf16`` the bank is bfloat16
    and the carry in the model's carry dtype (bfloat16 at this preset), as
    the rollout gives them; else both are float32. ``state`` is the carry
    stacked as the rollout keeps it."""
    G = G or train_config().rl.num_rollouts
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        enc = model.encode(corpus["feats"], corpus["masks"])
    dev = model.device
    dt = torch.bfloat16 if bf16 else torch.float32
    carry_dt = enc.carry[0][0].dtype if bf16 else torch.float32
    carry = tuple(
        tuple((x.float()[None].expand(G, -1, -1)
               + 0.1 * torch.randn((G,) + tuple(x.shape), generator=g).to(dev)
               ).to(carry_dt).contiguous() for x in layer)
        for layer in enc.carry)
    token = torch.randint(3, model.cfg.vocab_size, (G, TRAIN_B),
                          generator=g).to(dev)
    return dict(carry=carry, state=stack_carry(carry), token=token,
                w=stride_weights(model.cell),
                bank=(enc.memory.to(dt), enc.memory_proj.to(dt),
                      enc.memory_mask))


def run_step_kernel(model, x, state=None):
    """The rollout's call: the step on the stacked carry, in place."""
    return fused_decode_step_(
        model.cell, x["state"] if state is None else state, x["token"],
        *x["bank"], x["carry"][0][0].dtype, weights=x["w"])


def run_step_plain(x):
    w = x["w"]
    return decode_step_plain(w, x["carry"], w.embt[x["token"].long()],
                             *x["bank"])


def compare_step(model, x) -> dict:
    """Logits within TOL; the carry within TOL, plus one bfloat16 ulp (2^-7
    of the value) where the carry is rounded to bfloat16: the kernel rounds
    float32 values that differ from the plain version's in the last bits."""
    dtype = x["carry"][0][0].dtype
    state = stack_carry(x["carry"])
    klog = run_step_kernel(model, x, state)
    kc = unstack_carry(state, dtype)
    pc, plog = run_step_plain(x)
    torch.cuda.synchronize()
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    err = 0.0
    for (a, b), rel in [((klog, plog), TOL)] + [
            (p, TOL + ulp) for kl, pl in zip(kc, pc) for p in zip(kl, pl)]:
        d = (a.float() - b.float()).abs()
        check(bool((d <= TOL + rel * b.float().abs()).all()),
              f"decode step: error {float(d.max()):.3e}")
        err = max(err, float(d.max()))
    return {"max_abs_err": err, "carry_dtype": str(dtype)[6:]}


def step_bound(model, x) -> tuple[float, str]:
    """Bytes: the float32 weights the step reads (not the embedding table:
    its rows are gathered outside), the gathered rows, the bank, the carry
    in and out and the logits; operations: 2 per weight per (lane, row)
    plus the attention over the row's slots, in float32."""
    cfg = model.cfg
    w = x["w"]
    G, B = x["token"].shape
    E, H, A, V, L = (cfg.d_embed, cfg.d_hidden, cfg.d_att, cfg.vocab_size,
                     cfg.num_layers)
    mem, proj, mask = x["bank"]
    M, Em = mem.shape[1], mem.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (
        w.wq, w.bq, w.v, w.wx, w.wh, w.bg, w.wo, w.bo, mem, proj, mask))
    nbytes += G * B * (E + 4 * L * H + V) * 4
    per_row = 2 * (H * A + (E + Em) * 4 * H + (L - 1) * H * 4 * H
                   + L * H * 4 * H + H * V) + M * (4 * A + 2 * Em) + 10 * L * H
    t_ops = G * B * per_row / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def beam_inputs(model, corpus, bf16: bool, t: int, min_len: int,
                seed=4) -> dict:
    """The beam step's inputs at the eval path's shapes: W=5 lanes of the
    64 clips' encoder output with a perturbed carry, random last tokens,
    about 30% finished lanes and running scores, at step ``t``. With
    ``bf16`` the bank and the carry are bfloat16, as beam eval gives them
    at this preset; else float32."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        enc = model.encode(corpus["feats"], corpus["masks"])
    dev = model.device
    dt = torch.bfloat16 if bf16 else torch.float32
    carry_dt = enc.carry[0][0].dtype if bf16 else torch.float32
    carry = tuple(
        tuple((x.float()[None].expand(BEAM_W, -1, -1)
               + 0.1 * torch.randn((BEAM_W,) + tuple(x.shape), generator=g
                                   ).to(dev)).to(carry_dt).contiguous()
              for x in layer)
        for layer in enc.carry)
    token = torch.randint(3, model.cfg.vocab_size, (BEAM_W, TRAIN_B),
                          generator=g).to(dev)
    finished = (torch.rand((BEAM_W, TRAIN_B), generator=g) < 0.3).to(dev)
    scores = (-3.0 * t * torch.rand((BEAM_W, TRAIN_B), generator=g)).to(dev)
    return dict(carry=carry, state=stack_carry(carry), token=token,
                finished=finished, scores=scores, t=t, min_len=min_len,
                w=stride_weights(model.cell),
                bank=(enc.memory.to(dt), enc.memory_proj.to(dt),
                      enc.memory_mask),
                # the search's selection workspace, allocated once
                logits=torch.empty(
                    (beam_workspace(BEAM_W, TRAIN_B, model.cfg.vocab_size),),
                    device=dev))


def run_beam_kernel(model, x, state=None):
    """The search's call: the step on the stacked carry, in place."""
    return fused_beam_step_(
        model.cell, x["state"] if state is None else state, x["token"],
        x["finished"], x["scores"], *x["bank"], x["carry"][0][0].dtype,
        t=x["t"], min_len=x["min_len"], weights=x["w"], logits=x["logits"])


def run_beam_plain(x, width=None):
    w = x["w"]
    carry, logits = decode_step_plain(w, x["carry"], w.embt[x["token"].long()],
                                      *x["bank"])
    return (carry,) + beam_topk_plain(logits, x["finished"], x["scores"],
                                      t=x["t"], min_len=x["min_len"],
                                      width=width)


def compare_beam(model, x) -> dict:
    """Flat ids equal except where the plain version's totals tie within
    TOL at that position (its neighbours, the (W+1)-th included: counted
    as near-ties); scores within TOL; the carry as the decode step's."""
    dtype = x["carry"][0][0].dtype
    state = stack_carry(x["carry"])
    ksc, kfl = run_beam_kernel(model, x, state)
    kc = unstack_carry(state, dtype)
    pc, psc, pfl = run_beam_plain(x, width=BEAM_W + 1)
    torch.cuda.synchronize()
    ksc, kfl, psc, pfl = (v.cpu() for v in (ksc, kfl, psc, pfl))
    gap = psc[:, :-1] - psc[:, 1:]
    near = gap <= TOL
    near[:, 1:] |= gap[:, :BEAM_W - 1] <= TOL
    diff = kfl != pfl[:, :BEAM_W]
    check(not bool((diff & ~near).any()),
          f"beam step: flat ids differ away from a near-tie: "
          f"{int((diff & ~near).sum())} candidates")
    s_err = (ksc - psc[:, :BEAM_W]).abs()
    check(bool((s_err <= TOL + TOL * psc[:, :BEAM_W].abs()).all()),
          f"beam step: score error {float(s_err.max()):.3e}")
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    c_err = 0.0
    for kl, pl in zip(kc, pc):
        for a, b in zip(kl, pl):
            d = (a.float() - b.float()).abs()
            check(bool((d <= TOL + (TOL + ulp) * b.float().abs()).all()),
                  f"beam step: carry error {float(d.max()):.3e}")
            c_err = max(c_err, float(d.max()))
    V = model.cfg.vocab_size
    if x["t"] < x["min_len"]:
        check(not bool((kfl % V == EOS_ID).any()), "EOS chosen before min_len")
    fin = x["finished"].cpu()
    for g_, b in fin.nonzero().tolist():
        hit = (kfl[b] == g_ * V).nonzero()
        if len(hit):
            check(float(ksc[b, hit[0, 0]]) == float(x["scores"][g_, b]),
                  "a finished lane's PAD continuation moved its score")
    return {"max_abs_err": max(float(s_err.max()), c_err),
            "score_max_abs_err": float(s_err.max()),
            "near_tie_rows": int(diff.any(dim=1).sum()),
            "rows": int(diff.shape[0]), "finished_lanes": int(fin.sum()),
            "carry_dtype": str(dtype)[6:]}


def beam_bound(model, x) -> tuple[float, str]:
    """The decode step's bound without the logits' bytes (the TPU kernel
    keeps them on chip), plus the selection: bytes of the float32 weights,
    the bank, the gathered rows, the carry in and out, finished, scores
    and the [B, W] outputs; operations of the step and about 4 per logit
    (mask, max, exp, sum)."""
    cfg = model.cfg
    w = x["w"]
    W, B = x["token"].shape
    E, H, A, V, L = (cfg.d_embed, cfg.d_hidden, cfg.d_att, cfg.vocab_size,
                     cfg.num_layers)
    mem, proj, mask = x["bank"]
    M, Em = mem.shape[1], mem.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (
        w.wq, w.bq, w.v, w.wx, w.wh, w.bg, w.wo, w.bo, mem, proj, mask))
    nbytes += W * B * (E + 4 * L * H + 2) * 4 + 2 * B * W * 4
    per_row = 2 * (H * A + (E + Em) * 4 * H + (L - 1) * H * 4 * H
                   + L * H * 4 * H + H * V) + M * (4 * A + 2 * Em) \
        + 10 * L * H + 4 * V
    t_ops = W * B * per_row / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- phase 4: training -------------------------------------------------------


def plain_decode_step_(cell, state, token, memory, memory_proj, memory_mask,
                       carry_dtype, num_layers=None, emb=None, weights=None):
    """The in-place decode step through its plain version, on the card."""
    del num_layers
    w = weights if weights is not None else stride_weights(cell)
    emb = w.embt[token.long()] if emb is None else emb
    carry, logits = decode_step_plain(w, unstack_carry(state, carry_dtype),
                                      emb, memory, memory_proj, memory_mask)
    state.copy_(stack_carry(carry))
    return logits


def plain_dense_stride(cell, carry, token, finished, memory, memory_proj,
                       memory_mask, noise, t0=0, n_active=None, *, steps,
                       temperature=1.0, min_len=0, num_layers=None,
                       mem_lens=None, weights=None):
    """The dense stride through its plain version, on the card."""
    del num_layers
    B, M = memory.shape[:2]
    if mem_lens is None:
        mem_lens = torch.full((B,), M, dtype=torch.int32)
    return decode_stride_plain(
        weights if weights is not None else stride_weights(cell), carry,
        token, finished, memory, memory_proj, memory_mask, noise, int(t0),
        B if n_active is None else int(n_active), steps=steps,
        temperature=temperature, min_len=min_len, mem_lens=mem_lens)


def plain_beam_step_(cell, state, token, finished, scores, memory,
                     memory_proj, memory_mask, carry_dtype, *, t, min_len=0,
                     num_layers=None, weights=None, logits=None):
    """The in-place beam step through its plain version, on the card."""
    del num_layers, logits
    w = weights if weights is not None else stride_weights(cell)
    carry, top_scores, top_flat = beam_step_plain(
        w, unstack_carry(state, carry_dtype), w.embt[token.long()], finished,
        scores, memory, memory_proj, memory_mask, t=t, min_len=min_len)
    state.copy_(stack_carry(carry))
    return top_scores, top_flat


def plain_kernels():
    """Patch the plain versions in for the training and eval paths'
    kernels: attention, the decode step, the offline dense stride and the
    beam step."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        attention_ops, "fused_additive_attention", additive_attention_plain))
    stack.enter_context(mock.patch.object(
        decoding_common.decode_step_ops, "fused_decode_step_",
        plain_decode_step_))
    stack.enter_context(mock.patch.object(
        decoding_fused, "fused_decode_stride", plain_dense_stride))
    stack.enter_context(mock.patch.object(
        beam_ops, "fused_beam_step_", plain_beam_step_))
    return stack


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def launches() -> dict:
    return {"fused_additive_attention": fused_additive_attention.launches,
            "fused_decode_step": fused_decode_step.launches}


def all_launches() -> dict:
    return {**launches(),
            "fused_decode_stride": fused_decode_stride.launches,
            "fused_decode_stride_paged": fused_decode_stride_paged.launches,
            "fused_beam_step": fused_beam_step.launches}


def xe_phase(cfg, corpus, state) -> dict:
    """One XE step kernel vs plain from the same state and dropout seed,
    then XE_STEPS counted steps."""
    T = cfg.model.max_len
    dev = state.model.device
    step = make_xe_step(state.model, cfg.train.label_smoothing, guard=True)
    a, b = state.clone(), state.clone()
    _, km = step(a, *xe_batch(cfg, corpus, 0, dev))
    with plain_kernels():
        _, pm = step(b, *xe_batch(cfg, corpus, 0, dev))
    del a, b
    xe_rel = rel_err(km["loss"], pm["loss"])
    check(xe_rel <= REL_TOL, f"XE loss kernel {km['loss']} vs plain "
          f"{pm['loss']}: relative {xe_rel:.3e} > {REL_TOL}")
    ops.reset_launches()
    times, losses = [], []
    for i in range(XE_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, *xe_batch(cfg, corpus, i, dev))
        times.append(time.perf_counter() - t)       # the loss read syncs
        check(m["nonfinite"] == 0.0 and np.isfinite(m["loss"]),
              f"XE step {i} not finite: {m}")
        losses.append(m["loss"])
    n = launches()
    check(n == {"fused_additive_attention": T * XE_STEPS,
                "fused_decode_step": 0},
          f"XE launches {n}, expected {T} attention launches per step")
    ms = float(np.median(times)) * 1e3
    return {"steps": XE_STEPS, "launches": n, "losses": losses,
            "step_ms": [t * 1e3 for t in times], "step_ms_median": ms,
            "clips_per_s": TRAIN_B / (ms / 1e3), "plain_loss": pm["loss"],
            "kernel_loss": km["loss"], "loss_rel_err": xe_rel}


def cst_vs_plain(trainer, state, corpus) -> dict:
    """Decode from the same params and seed with the kernels and with the
    plain versions; then the update on the kernel's tokens from the same
    state, both ways."""
    feats, masks, vids = corpus["feats"], corpus["masks"], corpus["vids"]
    _, ks = trainer.decode(state.model, feats, masks, 99)
    with plain_kernels():
        _, ps = trainer.decode(state.model, feats, masks, 99)
    ks_np, ps_np = ks.cpu().numpy(), ps.cpu().numpy()
    Kr, B, T = ks_np.shape
    equal = (ks_np == ps_np).all(axis=-1).reshape(-1)
    share = float(equal.mean())
    check(share >= AGREE, f"rollout rows equal {share:.3f} < {AGREE}")
    rk = trainer.reward(vids, ks_np.reshape(Kr * B, T))
    rp = trainer.reward(vids, ps_np.reshape(Kr * B, T))
    check(np.array_equal(rk[equal], rp[equal]),
          "equal rollouts scored different rewards")
    valid = np.ones((B,), np.float32)
    adv, _ = trainer._advantage(None, ks_np, vids, valid)
    a, b = state.clone(), state.clone()
    _, km = trainer._apply(a, adv, {}, ks, feats, masks, valid)
    with plain_kernels():
        _, pm = trainer._apply(b, adv, {}, ks, feats, masks, valid)
    del a, b
    rl_rel = rel_err(km["rl_loss"], pm["rl_loss"])
    check(rl_rel <= REL_TOL, f"rl_loss kernel {km['rl_loss']} vs plain "
          f"{pm['rl_loss']}: relative {rl_rel:.3e} > {REL_TOL}")
    return {"rows_equal": share, "rows": int(equal.size),
            "kernel_rl_loss": km["rl_loss"], "plain_rl_loss": pm["rl_loss"],
            "rl_loss_rel_err": rl_rel}


def cst_phase(cfg, corpus, trainer, state) -> dict:
    agreement = cst_vs_plain(trainer, state, corpus)
    T = cfg.model.max_len
    ops.reset_launches()
    steps = []
    for i in range(CST_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, corpus["feats"], corpus["masks"],
                                      corpus["vids"], seed=100 + i)
        m["step_s"] = time.perf_counter() - t        # the loss read syncs
        check(m["nonfinite"] == 0.0 and np.isfinite(m["rl_loss"]),
              f"CST step {i} not finite: {m}")
        steps.append(m)
    n = launches()
    decode_steps = sum(m["decode_steps"] for m in steps)
    check(n == {"fused_additive_attention": T * CST_STEPS,
                "fused_decode_step": decode_steps},
          f"CST launches {n}: expected one decode-step launch per decode "
          f"step ({decode_steps}) and {T} attention launches per update")
    med = lambda key: float(np.median([m[key] for m in steps])) * 1e3  # noqa: E731
    return {"steps": CST_STEPS, "launches": n, "decode_steps": decode_steps,
            "step_ms_median": med("step_s"), "decode_ms": med("decode_s"),
            "reward_ms": med("reward_s"), "update_ms": med("update_s"),
            "rl_clips_per_s": TRAIN_B / (med("step_s") / 1e3),
            "reward_mean": [m["reward_mean"] for m in steps],
            "rl_loss": [m["rl_loss"] for m in steps],
            "grad_norm": [m["grad_norm"] for m in steps], **agreement}


# ---- phase 5: beam-5 eval ---------------------------------------------------


@dataclasses.dataclass
class Record:
    video_id: str
    caption_ids: list
    captions: list
    weights: list


class MemoryDataset:
    """``CaptionDataset``'s interface over a corpus held in memory: the
    split's records, feature stores (name -> ``.dim``), ``features_for``
    and the reference pools."""

    def __init__(self, corpus: dict, mc, split: str = "test"):
        self.vocab = corpus["vocab"]
        self.split = split
        self.max_frames = mc.max_frames
        self.stores = {n: types.SimpleNamespace(dim=d)
                       for n, d in mc.modalities}
        self._feats = corpus["feats"]
        self._mask = corpus["mask"]
        self._row = {v: i for i, v in enumerate(corpus["vids"])}
        self.records = [
            Record(v, ids, caps, [1.0] * len(caps)) for v, ids, caps in zip(
                corpus["vids"], corpus["caption_ids"],
                corpus["gts"].values())]

    def features_for(self, video_id: str) -> dict:
        i = self._row[video_id]
        return {n: (x[i], self._mask[i]) for n, x in self._feats.items()}

    def gts_pool(self) -> dict:
        return {r.video_id: list(r.captions) for r in self.records}


def fitted_model(cfg, corpus, dev):
    """A model past its first XE epochs: ``train_model``'s prior with +3
    on EOS, then FIT_STEPS XE steps (Adam at FIT_LR, the preset's dropout)
    over the corpus (on the card) in batches of 64, each clip's reference
    ``step % refs``. A model with the prior alone is the same at every
    step, so beam search ranks the empty caption first and greedy decoding
    emits EOS at once; the short fit makes EOS depend on the position, as
    in a trained model, so captions end before max_len with words in them.
    The fit sees the clips it is then scored on: the metrics measure the
    path, not the model. -> (model in eval mode, the fit's last loss)."""
    mc = cfg.model
    model = train_model(cfg, corpus, dev, eos_bias=3.0)
    state = create_train_state(
        model, make_optimizer(cfg.train, 1, lr_override=FIT_LR),
        seed=cfg.train.seed)
    step = make_xe_step(model, cfg.train.label_smoothing)
    n = len(corpus["vids"]) // EVAL_B
    ones = torch.ones(EVAL_B, device=dev)
    loss = float("nan")
    for i in range(FIT_STEPS):
        rows = slice((i % n) * EVAL_B, (i % n + 1) * EVAL_B)
        enc = [encode_label_row(ids[i % len(ids)], mc.max_len)
               for ids in corpus["caption_ids"][rows]]
        state, m = step(
            state, {k: x[rows] for k, x in corpus["feats"].items()},
            {k: x[rows] for k, x in corpus["masks"].items()},
            torch.from_numpy(np.stack([r[0] for r in enc])).long().to(dev),
            torch.from_numpy(np.stack([r[1] for r in enc])).to(dev), ones)
        loss = m["loss"]
    check(np.isfinite(loss), f"model fit: loss {loss}")
    return model.eval(), loss


def eval_config():
    """msrvtt_eval_beam5 with the beam-step kernel."""
    exp = get_experiment("msrvtt_eval_beam5")
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, decode_impl="pallas"))


def counted_beam_steps():
    """Count the beam search's loop steps, apart from any kernel counter:
    wrap the early-exit loop's step function."""
    n = [0]
    real = decoding_beam.scan_until_finished

    def scan(step, init, length, get_finished, y_fills):
        def counted(state, t):
            n[0] += 1
            return step(state, t)
        return real(counted, init, length, get_finished, y_fills)

    return n, mock.patch.object(decoding_beam, "scan_until_finished", scan)


def eval_phase(cfg, data, model) -> dict:
    """Evaluator.evaluate (pipelined) over the split, the kernel launches
    against the beam steps, then the same batches through the plain beam
    step on the card."""
    ec = cfg.eval
    ev = Evaluator(model, data, ec, batch_size=EVAL_B)
    steps, counting = counted_beam_steps()
    torch.cuda.synchronize()
    ops.reset_launches()
    with counting:
        t = time.perf_counter()
        res = ev.evaluate()
        wall = time.perf_counter() - t
    n = all_launches()
    check(n["fused_beam_step"] == steps[0] > 0,
          f"eval: {n['fused_beam_step']} beam-step launches for {steps[0]} "
          "beam steps")
    check(all(v == 0 for k, v in n.items() if k != "fused_beam_step"),
          f"eval launched other kernels: {n}")
    caps = res["captions"]
    check(len(caps) == len(data.records), f"{len(caps)} captions for "
          f"{len(data.records)} clips")
    metrics = res["metrics"]
    keys = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr", "CIDEr-D",
            "METEOR_approx", "ROUGE_L"]
    check(sorted(metrics) == keys and all(np.isfinite(metrics[k])
                                          for k in keys),
          f"eval metrics {metrics}")
    with plain_kernels():
        t = time.perf_counter()
        plain = ev.generate()
        plain_wall = time.perf_counter() - t
    agree = float(np.mean([caps[v] == plain[v] for v in caps]))
    check(agree >= AGREE, f"eval: kernel/plain caption agreement {agree:.3f} "
          f"< {AGREE}")
    lens = [len(c.split()) for c in caps.values()]
    tm = ev.timing
    return {"clips": len(caps), "batch": EVAL_B, "beam": ec.beam_size,
            "beam_steps": steps[0], "launches": n,
            "decode_clips_per_s": len(caps) / tm["decode_s"],
            "decode_s": tm["decode_s"], "score_s": tm["score_s"],
            "eval_wall_s": wall, "drain_s": tm["drain_s"],
            "plain_agreement": agree, "plain_generate_s": plain_wall,
            "caption_words_mean": float(np.mean(lens)),
            "distinct_captions": len(set(caps.values())),
            "metrics": metrics, "sample_caption": next(iter(caps.values()))}


# ---- phase 6: greedy-baseline SCST ------------------------------------------


def scst_config():
    """msrvtt_scst with the attention, decode-step and stride kernels."""
    exp = get_experiment("msrvtt_scst")
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, attention_impl="pallas", decode_impl="pallas"))


def scst_vs_plain(trainer, state, corpus) -> dict:
    """Greedy and sampled rows from the same params and seed with the
    kernels and with the plain versions; the update on the kernel's rows
    from the same state, both ways."""
    feats, masks, vids = corpus["feats"], corpus["masks"], corpus["vids"]
    kg, ks = trainer.decode(state.model, feats, masks, 99)
    with plain_kernels():
        pg, ps = trainer.decode(state.model, feats, masks, 99)
    rows_k = torch.cat([kg[None], ks]).cpu().numpy()
    rows_p = torch.cat([pg[None], ps]).cpu().numpy()
    equal = (rows_k == rows_p).all(axis=-1)                      # [1+K, B]
    share = float(equal.mean())
    check(share >= AGREE, f"scst rows equal {share:.3f} < {AGREE}")
    valid = np.ones((len(vids),), np.float32)
    adv, host = trainer._advantage(rows_k[0], rows_k[1:], vids, valid)
    a, b, c = state.clone(), state.clone(), state.clone()
    _, km = trainer._apply(a, adv, {}, ks, feats, masks, valid)
    with plain_kernels():
        _, pm = trainer._apply(b, adv, {}, ks, feats, masks, valid)
        # the loss's scale: its terms' magnitudes, |advantage| x -logprob,
        # summed as the loss is. The greedy baseline's advantages take
        # both signs and cancel in the loss, so its error is held to this
        _, am = trainer._apply(c, np.abs(adv), {}, ks, feats, masks, valid)
    del a, b, c
    err = abs(km["rl_loss"] - pm["rl_loss"])
    rl_scaled = err / max(am["rl_loss"], 1e-30)
    check(rl_scaled <= BF16_ROUND, f"scst rl_loss kernel {km['rl_loss']} vs "
          f"plain {pm['rl_loss']}: error {err:.3e} is {rl_scaled:.3e} of the "
          f"loss's scale {am['rl_loss']:.4f} > {BF16_ROUND}")
    rel = rel_err(km["rl_loss"], pm["rl_loss"])
    check(rel <= REL_TOL, f"scst rl_loss kernel {km['rl_loss']} vs plain "
          f"{pm['rl_loss']}: relative error {rel:.3e} > {REL_TOL}")
    return {"greedy_rows_equal": float(equal[0].mean()),
            "sampled_rows_equal": float(equal[1:].mean()),
            "kernel_rl_loss": km["rl_loss"], "plain_rl_loss": pm["rl_loss"],
            "rl_loss_scale": am["rl_loss"], "rl_loss_err_over_scale":
            rl_scaled, "rl_loss_gate": BF16_ROUND,
            "rl_loss_rel_err": rel, "rl_loss_rel_gate": REL_TOL,
            "greedy_reward_mean": host["baseline_mean"]}


def scst_phase(cfg, corpus, trainer, state) -> dict:
    agreement = scst_vs_plain(trainer, state, corpus)
    T, S = cfg.model.max_len, cfg.model.decode_stride
    ops.reset_launches()
    steps = []
    for i in range(SCST_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, corpus["feats"], corpus["masks"],
                                      corpus["vids"], seed=300 + i)
        m["step_s"] = time.perf_counter() - t        # the loss read syncs
        check(m["nonfinite"] == 0.0 and np.isfinite(m["rl_loss"]),
              f"SCST step {i} not finite: {m}")
        steps.append(m)
    n = all_launches()
    strides = sum(-(-m["decode_steps"] // S) for m in steps)
    check(n["fused_decode_stride"] == strides,
          f"SCST: {n['fused_decode_stride']} stride launches for {strides} "
          "strides")
    check(n["fused_additive_attention"] == T * SCST_STEPS,
          f"SCST: {n['fused_additive_attention']} attention launches, "
          f"expected {T} per update")
    check(n["fused_decode_step"] == n["fused_beam_step"] ==
          n["fused_decode_stride_paged"] == 0,
          f"SCST launched other kernels: {n}")
    med = lambda key: float(np.median([m[key] for m in steps])) * 1e3  # noqa: E731
    return {"steps": SCST_STEPS, "launches": n, "strides": strides,
            "decode_steps": [m["decode_steps"] for m in steps],
            "step_ms_median": med("step_s"), "decode_ms": med("decode_s"),
            "reward_ms": med("reward_s"), "update_ms": med("update_s"),
            "rl_clips_per_s": TRAIN_B / (med("step_s") / 1e3),
            "reward_mean": [m["reward_mean"] for m in steps],
            "baseline_mean": [m["baseline_mean"] for m in steps],
            "rl_loss": [m["rl_loss"] for m in steps], **agreement}


# ---- phase 6b: decoupled actor/learner SCST ---------------------------------

RL_DEVICE = "cuda"
RL_CLIPS, RL_BATCHES = 60, 6   # 4 wrap-padded rows a batch of 64
DRAIN_AFTER_BATCHES = 3
# depth 3, bound 1 over 6 batches: the staleness ledger and drop count of
# the JAX AsyncSCSTTrainer(mesh=None) on the same schedule (they depend on
# the schedule alone; tests/test_torch_async_scst.py holds the port to it)
D3B1_STALENESS, D3B1_DROPPED = {0: 5, 1: 1}, 4


def host_clips(c: dict, n: int) -> dict:
    """The first ``n`` clips of a host corpus (``make_corpus``)."""
    vids = c["vids"][:n]
    return {**c, "feats": {k: x[:n] for k, x in c["feats"].items()},
            "mask": c["mask"][:n], "vids": vids,
            "caption_ids": c["caption_ids"][:n],
            "gts": {v: c["gts"][v] for v in vids}}


def decoupled_batches(cfg, host: dict, dev) -> list:
    """RL_BATCHES video-mode batches of TRAIN_B over RL_CLIPS clips of the
    train corpus (each shuffled epoch one batch, its last rows
    wrap-padded and invalid), staged on the card once."""
    mc = cfg.model
    batcher = Batcher(MemoryDataset(host_clips(host, RL_CLIPS), mc, "train"),
                      batch_size=TRAIN_B, max_len=mc.max_len, mode="video",
                      seed=cfg.data.shuffle_seed)
    out = []
    for e in range(RL_BATCHES):
        batcher.epoch_index = e
        (b,) = list(batcher.epoch(shuffle=True))
        out.append(({k: torch.from_numpy(x).to(dev)
                     for k, x in b.feats.items()},
                    {k: torch.from_numpy(x).to(dev)
                     for k, x in b.feat_masks.items()},
                    list(b.video_ids), [bool(v) for v in b.valid]))
    return out


def counted_sample_steps():
    """Count the sampler's decode steps apart from any kernel counter:
    wrap its early-exit loop's step function (recounts included)."""
    n = [0]
    real = decoding_sample.scan_until_finished

    def scan(step, init, length, get_finished, y_fills):
        def counted(state, t):
            n[0] += 1
            return step(state, t)
        return real(counted, init, length, get_finished, y_fills)

    return n, mock.patch.object(decoding_sample, "scan_until_finished", scan)


class RecordingReward:
    """A reward computer that keeps every row batch it scores."""

    def __init__(self, reward):
        self.reward = reward
        self.calls: list = []

    def __call__(self, video_ids, rows):
        self.calls.append(np.asarray(rows).copy())
        return self.reward(video_ids, rows)


def rl_decoupled_phase(cfg, host: dict, fit_sd: dict, smi: str
                       ) -> tuple[dict, dict]:
    """The decoupled trainer at msrvtt_cst_consensus width (module
    docstring, 6b) -> (its line, the counted run's launches)."""
    dev = torch.device(RL_DEVICE)
    t_phase = time.perf_counter()
    rl, T = cfg.rl, cfg.model.max_len
    reward = RewardComputer(
        host["vocab"], host["gts"], cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads)
    batches = decoupled_batches(cfg, host, dev)
    base = cfg.train.seed + 1

    def seeds(offset=0):
        return lambda j: rollout_seed(base, 0, 0, offset + j)

    def fresh():
        model = CaptionModel(cfg.model, device=dev)
        model.load_state_dict(fit_sd)
        return create_train_state(
            model, make_optimizer(cfg.train, 1, lr_override=rl.lr),
            seed=cfg.train.seed)

    def run(kind, rl_cfg, rew=reward, state=None, data=batches, offset=0,
            **kw):
        state = state or fresh()
        if kind == "sync":
            tr = SCSTTrainer(state.model, rew, rl_cfg, guard=True)
        else:
            tr = AsyncSCSTTrainer(state.model, rew, rl_cfg, guard=True,
                                  strict=kind == "strict",
                                  batch_size=TRAIN_B)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, ms = tr.train_epoch(state, data, seeds(offset),
                                   pipelined=rl_cfg.pipelined, **kw)
        torch.cuda.synchronize()
        for m in ms:
            check(m["nonfinite"] == 0.0 and np.isfinite(m["rl_loss"]),
                  f"rl_decoupled: a {kind} step is not finite: {m}")
        return {"trainer": tr, "state": state, "metrics": ms,
                "wall": time.perf_counter() - t}

    def same(a, b, what):
        check([m["rl_loss"] for m in a["metrics"]]
              == [m["rl_loss"] for m in b["metrics"]]
              and [m["reward_mean"] for m in a["metrics"]]
              == [m["reward_mean"] for m in b["metrics"]]
              and all(torch.equal(x, y) for x, y in zip(
                  a["state"].model.parameters(),
                  b["state"].model.parameters())),
              f"rl_decoupled: {what} differ")

    # strict, pipelined: the sync loop's pipeline, in turns with it (sync,
    # strict, strict, sync, twice)
    rl_p = dataclasses.replace(rl, pipelined=True)
    order = ("sync", "strict", "strict", "sync") * 2
    turns = [run(kind, rl_p) for kind in order]
    sync_runs = [r for k, r in zip(order, turns) if k == "sync"]
    strict_runs = [r for k, r in zip(order, turns) if k == "strict"]
    same(sync_runs[0], strict_runs[0], "strict pipelined and sync pipelined")
    for r in strict_runs[1:]:
        same(strict_runs[0], r, "strict runs")
    for r in sync_runs[1:]:
        same(sync_runs[0], r, "sync runs")
    # strict, sequential; depth 1 with bound 0 is strict without the flag
    rl_s = dataclasses.replace(rl, pipelined=False)
    seq = run("sync", rl_s)
    same(seq, run("strict", rl_s), "strict sequential and sync sequential")
    implicit = run("async", dataclasses.replace(
        rl_s, rollout_depth=1, staleness_bound=0))
    check(implicit["trainer"]._strict, "depth 1 bound 0 is not strict")
    same(seq, implicit, "depth 1 bound 0 and sync sequential")
    del seq, implicit
    # depth 3, bound 1: drops and recounts. The counted run of the path
    rl_d = dataclasses.replace(rl, rollout_depth=3, staleness_bound=1)
    steps, counting = counted_sample_steps()
    ops.reset_launches()
    with counting:
        d3 = run("async", rl_d)
    n = all_launches()
    tr3 = d3["trainer"]
    check(tr3.last_staleness == D3B1_STALENESS
          and tr3.last_dropped == D3B1_DROPPED,
          f"rl_decoupled: depth 3 bound 1 staleness {tr3.last_staleness}, "
          f"dropped {tr3.last_dropped}; the JAX trainer's: "
          f"{D3B1_STALENESS}, {D3B1_DROPPED}")
    check(n["fused_decode_step"] == steps[0] > 0,
          f"rl_decoupled: {n['fused_decode_step']} decode-step launches for "
          f"{steps[0]} decode steps (recounts included)")
    check(n["fused_additive_attention"] == T * RL_BATCHES,
          f"rl_decoupled: {n['fused_additive_attention']} attention "
          f"launches, expected {T} per update")
    check(n["fused_decode_stride"] == n["fused_decode_stride_paged"]
          == n["fused_beam_step"] == 0,
          f"rl_decoupled launched other kernels: {n}")
    d3b = run("async", rl_d)
    same(d3, d3b, "two depth-3 runs")
    # a drain after batch 3 persists the ring through seam.npz; the
    # strict resume replays it and equals the uninterrupted run
    calls = [0]

    def stop():
        calls[0] += 1
        return calls[0] > DRAIN_AFTER_BATCHES

    sink: dict = {}
    part = run("strict", rl_p, should_stop=stop, seam_sink=sink)
    done = len(part["metrics"])
    ring = sink.get("ring", [])
    check(len(ring) == DRAIN_AFTER_BATCHES - done > 0,
          f"rl_decoupled: drain persisted {len(ring)} ring entries after "
          f"{done} updates")
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "step_00000001"))
        with open(os.path.join(root, "step_00000001", "seam.npz"),
                  "wb") as f:
            f.write(trainer_mod.Trainer._seam_bytes(sink, 0, done))
        quiet = types.SimpleNamespace(
            log=types.SimpleNamespace(log=lambda *a, **k: None))
        seam = trainer_mod.Trainer._load_seam(
            quiet, root, {"ckpt_name": "step_00000001", "phase": "rl",
                          "batch_index": done})
    check(seam is not None and len(seam["ring"]) == len(ring),
          "rl_decoupled: the ring seam did not load")
    rec = RecordingReward(reward)
    resumed = run("strict", rl_p, rew=rec, state=part["state"],
                  data=batches[done:], offset=done, seam=seam)
    check(np.array_equal(rec.calls[0], ring[0]["samples"].reshape(-1, T)),
          "rl_decoupled: the resume did not replay the persisted tokens")
    same(strict_runs[0], {"state": resumed["state"],
                    "metrics": part["metrics"] + resumed["metrics"]},
         "the drained and resumed run and the uninterrupted one")
    rate = lambda r: RL_BATCHES * TRAIN_B / r["wall"]  # noqa: E731
    return {"phase": "rl_decoupled", "preset": cfg.name, "batch": TRAIN_B,
            "batches": RL_BATCHES, "valid_rows_per_batch": RL_CLIPS,
            "rollouts": rl.num_rollouts, "baseline": rl.baseline,
            "launches": n, "decode_steps": steps[0],
            "d3b1_staleness": {str(k): v
                               for k, v in tr3.last_staleness.items()},
            "d3b1_dropped": tr3.last_dropped,
            "sync_clips_per_s": [rate(r) for r in sync_runs],
            "strict_clips_per_s": [rate(r) for r in strict_runs],
            "d3b1_clips_per_s": [rate(d3), rate(d3b)],
            "strict_over_sync": (
                float(np.median([rate(r) for r in strict_runs]))
                / float(np.median([rate(r) for r in sync_runs]))),
            "occupancy_strict": [r["trainer"].last_occupancy
                                 for r in strict_runs],
            "occupancy_d3b1": tr3.last_occupancy,
            "reward_mean": [m["reward_mean"]
                            for m in strict_runs[0]["metrics"]],
            "drain": {"updates_before": done, "ring_entries": len(ring)},
            "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi}, n


# ---- phase 6c: online SCST from served traffic -------------------------------

ONLINE_REQUESTS = 256
ONLINE_RL = dict(online_batch_size=16, rollout_depth=2, staleness_bound=4,
                 swap_every=1)


def online_requests(host: dict, mc, n_requests: int = ONLINE_REQUESTS
                    ) -> list:
    """``n_requests`` requests of a seeded Poisson trace (its seeds and
    order), each named after a train-corpus clip (``<clip>#<i>``) and
    carrying that clip's frames. Served as a burst: admission, and with it
    the learner, does not depend on the clock."""
    trace = make_trace(TrafficSpec(num_requests=n_requests, seed=11))
    n = len(host["vids"])
    out = []
    for i, item in enumerate(trace.items):
        c = i % n
        F = int(host["mask"][c].sum())
        out.append(ClipRequest(
            f"{host['vids'][c]}#{i:04d}",
            {k: x[c, :F] for k, x in host["feats"].items()},
            {k: np.ones((F,), np.float32) for k, _ in mc.modalities},
            seed=item.seed))
    return out


def rl_online_phase(host: dict, fit_sd: dict, smi: str) -> tuple[dict, dict]:
    """Online SCST against the serve model (module docstring, 6c) ->
    (its line, the counted run's launches)."""
    dev = torch.device(RL_DEVICE)
    t_phase = time.perf_counter()
    scfg = scst_config()
    rl = dataclasses.replace(scfg.rl, **ONLINE_RL)
    Kr, T = rl.num_rollouts, scfg.model.max_len
    serve_cfg = model_config()
    learn_cfg = dataclasses.replace(serve_cfg, attention_impl="pallas")
    reqs = online_requests(host, serve_cfg)
    by_id = {r.req_id: r for r in reqs}
    reward = RewardComputer(
        host["vocab"], host["gts"], cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads)

    def model_of(cfg, sd):
        m = CaptionModel(cfg, device=dev)
        m.load_state_dict(sd)
        return m.eval()

    def svc_of(model):
        return CaptionService(model, capacity=CAPACITY, num_rollouts=Kr,
                              stride=S, frame_bucket=FRAME_BUCKET,
                              device=SERVE_DEVICE)

    def frozen():
        rep, wall = serve_timed(svc_of(model_of(serve_cfg, fit_sd)), reqs)
        check(rep.completed == ONLINE_REQUESTS,
              f"rl_online: frozen serve completed {rep.completed}")
        return {"report": rep, "wall": wall}

    def online():
        learner = model_of(learn_cfg, fit_sd)
        state = create_train_state(
            learner, make_optimizer(scfg.train, 1, lr_override=rl.lr),
            seed=scfg.train.seed)
        trainer = OnlineSCSTTrainer(learner, reward, rl, state, guard=True,
                                    ref_id=lambda r: r.req_id.split("#")[0])
        svc = svc_of(model_of(serve_cfg, fit_sd))
        trainer.attach(svc)
        published = {0: {k: v.clone() for k, v in fit_sd.items()}}
        publish = svc.publish_params

        def recorded(params, version=None):
            published[version] = {k: v.detach().clone()
                                  for k, v in params.state_dict().items()}
            return publish(params, version=version)

        svc.publish_params = recorded
        pairs = counted_strides(svc)
        names = ("rl.online.steps", "rl.online.batches",
                 "rl.online.dropped_stale", "serving.param_swaps")
        before = {k: tobs.counter(k).value for k in names}
        rep, wall = serve_timed(svc, reqs)
        trainer.flush()
        counters = {k: tobs.counter(k).value - before[k] for k in names}
        check(rep.completed == ONLINE_REQUESTS,
              f"rl_online: online serve completed {rep.completed}")
        return {"report": rep, "wall": wall, "trainer": trainer, "svc": svc,
                "published": published, "pairs": pairs,
                "counters": counters}

    # in turns: frozen, online, online, frozen, twice; the first online
    # run is the path's counted run
    f1 = frozen()
    ops.reset_launches()
    o1 = online()
    n = all_launches()
    onl, frz = [o1], [f1]
    for kind in ("online", "frozen", "frozen", "online", "online", "frozen"):
        if kind == "online":
            onl.append(online())
        else:
            frz.append(frozen())
    tr, rep, svc = o1["trainer"], o1["report"], o1["svc"]
    batches = ONLINE_REQUESTS // rl.online_batch_size
    pending = svc._pending_publish is not None
    c = o1["counters"]
    check(tr.last_applied + tr.last_dropped == batches
          and c["rl.online.batches"] == batches
          and c["rl.online.steps"] == tr.last_applied == tr.version
          and c["rl.online.dropped_stale"] == tr.last_dropped,
          f"rl_online: applied {tr.last_applied}, dropped "
          f"{tr.last_dropped}, counters {c}, {batches} batches")
    # every update publishes (swap_every 1); a publish staged while a
    # newer one lands before the next stride boundary is superseded
    publishes = len(o1["published"]) - 1
    swaps = len(svc._swap_history)
    check(tr.last_applied >= 2 and publishes == tr.last_applied
          and 1 <= swaps <= publishes - pending
          and c["serving.param_swaps"] == swaps,
          f"rl_online: {tr.last_applied} updates, {publishes} publishes, "
          f"{swaps} swaps (+{int(pending)} pending), counter "
          f"{c['serving.param_swaps']}")
    check(n["fused_decode_stride_paged"] == sum(o1["pairs"])
          and n["fused_additive_attention"] == T * tr.last_applied
          and n["fused_decode_stride"] == n["fused_decode_step"]
          == n["fused_beam_step"] == 0,
          f"rl_online launches {n}: expected {sum(o1['pairs'])} paged "
          f"(stride, live version) pairs and {T} attention launches for "
          f"each of {tr.last_applied} updates")
    by_ver: dict = {}
    for rid, res in rep.results.items():
        by_ver.setdefault(res.param_version, []).append(rid)
    check(len(by_ver) >= 2 and max(o1["pairs"]) >= 2,
          f"rl_online: requests pinned {sorted(by_ver)}, at most "
          f"{max(o1['pairs'])} live versions a stride")
    # each version's requests, replayed by a fresh service under it
    # (bitwise), and decoded offline through fused_decode (kernel 3)
    ops.reset_launches()
    strides = 0
    rows_equal, rows, lp_err = 0, 0, 0.0
    for v, rids in sorted(by_ver.items()):
        model = model_of(serve_cfg, o1["published"][v])
        again = svc_of(model).serve([by_id[r] for r in rids])
        for r in rids:
            check(same_result(again.results[r], rep.results[r]),
                  f"rl_online: {r} differs from itself replayed under "
                  f"version {v}")
        for r in rids:
            # one request a decode, its frames padded as the service pads
            # them: the encoder runs the service's shapes, and the dense
            # stride kernel is the only difference
            q, res = by_id[r], rep.results[r]
            F = q.num_frames
            Fp = min(-(-F // FRAME_BUCKET) * FRAME_BUCKET,
                     serve_cfg.max_frames)
            feats = {k: torch.from_numpy(np.pad(
                x, ((0, Fp - F), (0, 0))))[None].to(dev)
                for k, x in q.feats.items()}
            masks = {k: torch.from_numpy(np.pad(
                x, ((0, Fp - F),)))[None].to(dev) for k, x in q.masks.items()}
            seed_t = torch.tensor([q.seed], dtype=torch.int64, device=dev)
            noise = lambda t, s=seed_t: counter_gumbel_noise(  # noqa: E731
                s, torch.full((1, 1), t, dtype=torch.int64, device=dev), Kr,
                serve_cfg.vocab_size)[0]
            g, glp, smp, slp = decoding_fused.fused_decode(
                model, feats, masks, num_rollouts=Kr, max_len=T,
                noise_fn=noise)
            toks = torch.cat([g[None], smp])[:, 0].cpu().numpy()  # [G, T]
            lps = torch.cat([glp[None], slp])[:, 0].cpu().numpy()
            strides += -(-decode_depth(toks, T, S) // S)
            eq = (toks == res.tokens).all(axis=-1)
            rows_equal += int(eq.sum())
            rows += eq.size
            if eq.any():
                lp_err = max(lp_err, float(np.abs(
                    lps[eq] - res.logprobs[eq]).max()))
    dense = fused_decode_stride.launches
    check(dense == strides, f"rl_online: {dense} dense stride launches for "
          f"{strides} strides of the offline decode")
    share = rows_equal / rows
    check(share >= AGREE and lp_err <= TOL,
          f"rl_online: offline fused_decode rows equal {share:.3f} "
          f"(>= {AGREE}), logprob error {lp_err:.3e} (<= {TOL})")
    # the other online runs on the same trace
    for o in onl[1:]:
        t2 = o["trainer"]
        check(t2.last_staleness == tr.last_staleness
              and [m["rl_loss"] for m in t2.history]
              == [m["rl_loss"] for m in tr.history]
              and all(torch.equal(x, y) for x, y in zip(
                  tr.state.model.parameters(),
                  t2.state.model.parameters())),
              "rl_online: two online runs on one trace differ")
    lat = lambda r: float(np.percentile(  # noqa: E731
        [x.latency_s for x in r["report"].results.values()], 99))
    rps = lambda r: ONLINE_REQUESTS / r["wall"]  # noqa: E731
    n["fused_decode_stride"] = dense
    return {"phase": "rl_online", "preset": scfg.name,
            "serve": {"capacity": CAPACITY, "K": Kr, "stride": S,
                      "paged": True},
            "requests": ONLINE_REQUESTS, **ONLINE_RL,
            "launches": n, "version_pairs": sum(o1["pairs"]),
            "mixed_strides": sum(p > 1 for p in o1["pairs"]),
            "requests_by_version": {str(v): len(r)
                                    for v, r in sorted(by_ver.items())},
            "updates": tr.last_applied, "dropped": tr.last_dropped,
            "publishes": publishes, "swaps": swaps,
            "staleness": {str(k): v for k, v in
                          sorted(tr.last_staleness.items())},
            "reward_trend": [m["reward_mean"] for m in tr.history],
            "offline_rows_equal": share, "offline_logprob_max_err": lp_err,
            "frozen_requests_per_s": [rps(r) for r in frz],
            "online_requests_per_s": [rps(r) for r in onl],
            "frozen_p99_s": [lat(r) for r in frz],
            "online_p99_s": [lat(r) for r in onl],
            "online_over_frozen": (
                float(np.median([rps(r) for r in onl]))
                / float(np.median([rps(r) for r in frz]))),
            "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi}, n


# ---- phase 6d: one-device resilience ------------------------------------------

RES_DEVICE = "cuda"
RES_PREEMPT_AT = 3        # the xe.step visit the SIGTERM lands on
RES_NAN_AT = 2            # the xe.batch visit the NaN poisons
RES_STALL_S = 0.5         # the prefetch arm's stall watchdog: far above a
RES_WEDGE_S = 1.0         # B=64 batch's staging (18 MB), far below the wedge
RES_RL = dict(rollout_depth=3, staleness_bound=1)   # the actor arm's ring


def res_config(ckpt_dir: str, rl=None, **train):
    """msrvtt_cst_consensus at full width with the kernels, one XE and one
    RL epoch of B=64 over the recipe corpus's 384 train clips; ``rl``
    replaces the RL section."""
    cfg = get_preset("msrvtt_cst_consensus").override(
        model__attention_impl="pallas", model__decode_impl="pallas",
        train__epochs=1, train__log_every_steps=1, train__ckpt_dir=ckpt_dir,
        rl__epochs=1, **{f"train__{k}": v for k, v in train.items()})
    return cfg if rl is None else dataclasses.replace(cfg, rl=rl)


class XeStepTap:
    """Wraps a trainer's XE step: the params before and after each, and
    its non-finite flag."""

    def __init__(self, tr):
        self.real, self.steps = tr.xe_step, []
        tr.xe_step = self

    def __call__(self, state, *args):
        before = [p.detach().clone() for p in state.params]
        state, m = self.real(state, *args)
        self.steps.append((before, [p.detach().clone() for p in state.params],
                           float(m.get("nonfinite", 0.0))))
        return state, m


def _params_equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _res_events(path: str, name: str) -> list:
    return [e for e in map(json.loads, open(path)) if e["event"] == name]


def _res_raises(exc, fn):
    """-> the ``exc`` that ``fn()`` raised; fails if it raised none."""
    try:
        fn()
    except exc as e:
        return e
    check(False, f"resilience: expected {exc.__name__}")


def resilience_phase(model, reqs, smi: str) -> tuple[dict, dict]:
    """One seeded fault plan per arm through the port's trainer,
    prefetch, checkpoints, decoupled RL and serving at full width
    (module docstring, 6d) -> (its line, the launches of its runs)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        return _resilience(root, model, reqs, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _resilience(root: str, model, reqs, smi: str) -> tuple[dict, dict]:
    import signal

    from cst_captioning_tpu_torch.ckpt import CheckpointManager
    from cst_captioning_tpu_torch.resilience import (
        Fault, FaultPlan, Preempted, SimulatedKill, verify_manifest)

    t_phase = time.perf_counter()
    data = recipe_corpus(root)
    mc = get_preset("msrvtt_cst_consensus").model
    ds = CaptionDataset(data["info_json"],
                        {n: data[n] for n, _ in mc.modalities}, "train",
                        mc.max_frames)
    d = lambda name: os.path.join(root, name)  # noqa: E731
    total = dict.fromkeys(all_launches(), 0)
    arms: dict = {}
    recovery: dict = {}

    def trainer(cfg, log):
        return trainer_mod.Trainer(cfg, ds, None, log_path=log,
                                   device=RES_DEVICE)

    def arm(name, fn):
        """Run one arm with the launch counts set to 0 just before and read
        just after; -> the arm's own result."""
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        line, plan, out = fn()
        torch.cuda.synchronize()
        n = all_launches()
        for k, v in n.items():
            total[k] += v
        arms[name] = {**line, "fired": plan.fired, "launches": n,
                      "wall_s": time.perf_counter() - t}
        return out

    # 1. SIGTERM at xe.step: the mid-epoch save and resume equal the
    #    uninterrupted run (params and every step's loss)
    def preempt():
        cfg = res_config(d("straight"))
        straight = trainer(cfg, d("straight.jsonl"))
        straight.train_xe()
        straight.close()
        cfg2 = res_config(d("preempt"))
        tr = trainer(cfg2, d("preempt.jsonl"))
        prev = signal.getsignal(signal.SIGTERM)
        plan = FaultPlan([Fault("xe.step", "preempt", at=RES_PREEMPT_AT)])
        with plan.activate():
            _res_raises(Preempted, tr.train_xe)
        tr.close()
        check(signal.getsignal(signal.SIGTERM) == prev,
              "resilience: the trainer left its SIGTERM handler installed")
        (ev,) = _res_events(d("preempt.jsonl"), "preempt")
        check(ev["batch_index"] == RES_PREEMPT_AT + 1,
              f"resilience: preempted at batch {ev['batch_index']}")
        again = trainer(dataclasses.replace(cfg2, train=dataclasses.replace(
            cfg2.train, resume="auto")), d("resume.jsonl"))
        check(again._resume_batch == RES_PREEMPT_AT + 1,
              f"resilience: resumed at batch {again._resume_batch}")
        restore_ms = again.ckpt.last_restore.get("ms")
        again.train_xe()
        again.close()
        check(again.state.step == straight.state.step
              and _params_equal(again.state.params, straight.state.params),
              "resilience: the resumed run's params differ from the "
              "uninterrupted run's")
        want = {e["step"]: e["loss"]
                for e in _res_events(d("straight.jsonl"), "xe_step")}
        got = {e["step"]: e["loss"] for p in ("preempt", "resume")
               for e in _res_events(d(p + ".jsonl"), "xe_step")}
        check(got == want, "resilience: per-step losses differ across the "
              "preempt and resume")
        recovery["resume_restore_ms"] = restore_ms
        return ({"batch_index": ev["batch_index"], "steps": len(want),
                 "restore_ms": restore_ms, "bitwise": True}, plan, straight)

    straight = arm("preempt_xe_step", preempt)
    ref = [p.detach().clone() for p in straight.state.params]
    steps = straight.steps_per_epoch

    # 2. NaN at xe.batch under skip_batch; then debug_nans on the same
    #    batch, and a healthy debug_nans epoch against the straight run
    def nan_batch():
        tr = trainer(res_config(d("nan")), d("nan.jsonl"))
        tap = XeStepTap(tr)
        plan = FaultPlan([Fault("xe.batch", "nan", at=RES_NAN_AT)])
        with plan.activate():
            tr.train_xe()
        tr.close()
        flags = [s[2] for s in tap.steps]
        check(tr.xe_epochs == 1 and tr.state.step == steps - 1
              and flags == [float(i == RES_NAN_AT) for i in range(steps)],
              f"resilience: NaN epoch steps {tr.state.step}, flags {flags}")
        before, after, _ = tap.steps[RES_NAN_AT]
        check(_params_equal(before, after), "resilience: the poisoned step "
              "changed the params")
        check(all(bool(torch.isfinite(p).all()) for p in tr.state.params),
              "resilience: a param is not finite after the NaN batch")
        (div,) = _res_events(d("nan.jsonl"), "divergence")
        check(div["kind"] == "nonfinite" and div["action"] == "skip_batch",
              f"resilience: divergence event {div}")
        dbg = trainer(res_config(d("dbg_nan"), debug_nans=True),
                      d("dbg_nan.jsonl"))
        check(torch.is_anomaly_enabled(), "resilience: anomaly mode is off "
              "under debug_nans")
        plan2 = FaultPlan([Fault("xe.batch", "nan", at=RES_NAN_AT)])
        try:
            with plan2.activate():
                err = _res_raises(FloatingPointError, dbg.train_xe)
        finally:
            dbg.close()
        check("module '" in str(err) and not torch.is_anomaly_enabled(),
              f"resilience: debug_nans raised {err!r}")
        t = time.perf_counter()
        on = trainer(res_config(d("dbg_on"), debug_nans=True),
                     d("dbg_on.jsonl"))
        on.train_xe()
        on.close()
        dbg_s = time.perf_counter() - t
        check(_params_equal(on.state.params, ref),
              "resilience: a healthy epoch with debug_nans differs from one "
              "without")
        return ({"skipped_step": RES_NAN_AT, "steps": int(tr.state.step),
                 "debug_nans_error": str(err), "debug_nans_epoch_s": dbg_s,
                 "debug_nans_bitwise": True}, plan, None)

    arm("nan_xe_batch", nan_batch)

    # 3. a transient reward failure in the SCST epoch (greedy baseline, the
    #    dense stride kernel): one retry, params equal to the clean epoch
    scst_rl = dataclasses.replace(get_preset("msrvtt_scst").rl, epochs=1)

    def rl_run(name, plan, rl, **train):
        tr = trainer(res_config(d(name), rl=rl, **train), d(name + ".jsonl"))
        tr.load_params_from(d("straight"), "latest")
        with plan.activate():
            tr.train_rl()
        tr.close()
        return tr

    def reward_retry():
        clean = rl_run("rl_clean", FaultPlan([]), scst_rl)
        plan = FaultPlan([Fault("reward.call", "io_error", at=0)])
        tr = rl_run("rl_retry", plan, scst_rl)
        (ev,) = _res_events(d("rl_retry.jsonl"), "reward_retry")
        check(ev["error"] == "TransientIOError",
              f"resilience: reward_retry {ev}")
        check(_params_equal(tr.state.params, clean.state.params),
              "resilience: the retried SCST epoch differs from the clean one")
        return ({"retry": {k: ev[k] for k in ("attempt", "delay", "error")},
                 "rl_steps": len(_res_events(d("rl_retry.jsonl"), "rl_step")),
                 "bitwise": True}, plan, None)

    arm("io_error_reward_call", reward_retry)

    # 4. a torn H2D copy and a wedged worker: every batch arrives equal to a
    #    clean prefetch's, one retry, one stall
    def prefetch():
        batcher = Batcher(ds, batch_size=TRAIN_B, max_len=mc.max_len,
                          mode="caption")

        def transform(b):
            return (b.feats, b.feat_masks, b.labels.astype(np.int64), b.mask,
                    b.weights, np.asarray(b.valid, np.float32))

        def staged(plan):
            """-> (the batches, the consumer's longest wait for one)."""
            batcher.epoch_index = 0     # the same order each time
            out, waits = [], []
            with plan.activate():
                t = time.perf_counter()
                for b in prefetch_mod.prefetch_to_device(
                        batcher.epoch(), size=2, transform=transform,
                        device=RES_DEVICE, stall_warn_s=RES_STALL_S):
                    waits.append(time.perf_counter() - t)
                    out.append(b)
                    t = time.perf_counter()
            torch.cuda.synchronize()
            return out, max(waits)

        count = lambda n: tobs.counter(n).snapshot()  # noqa: E731
        ahead = count("resilience.prefetch_stall")
        clean, clean_wait = staged(FaultPlan([]))
        before = (count("resilience.h2d_retry"),
                  count("resilience.prefetch_stall"))
        check(before[1] == ahead, f"resilience: the clean prefetch stalled "
              f"{before[1] - ahead} times past {RES_STALL_S} s (longest wait "
              f"{clean_wait:.3f} s)")
        plan = FaultPlan([Fault("prefetch.h2d", "partial_h2d", at=1),
                          Fault("prefetch.stage", "wedged_prefetch", at=2,
                                delay=RES_WEDGE_S)])
        got, wedged_wait = staged(plan)
        after = (count("resilience.h2d_retry"),
                 count("resilience.prefetch_stall"))
        check(len(got) == len(clean) == steps
              and all(_same(a, b) for a, b in zip(got, clean)),
              "resilience: a prefetched batch differs from the clean run's")
        check(after[0] - before[0] == 1 and after[1] - before[1] == 1,
              f"resilience: h2d retries and stalls {before} -> {after}")
        return ({"batches": len(got), "h2d_retries": after[0] - before[0],
                 "stalls": after[1] - before[1], "bitwise": True,
                 "clean_max_wait_s": clean_wait,
                 "wedged_max_wait_s": wedged_wait}, plan, None)

    arm("partial_h2d_wedged_prefetch", prefetch)

    # 5. ENOSPC mid-rotation, then a kill before the swap, on the trained
    #    state: the oldest generation pays, the previous one survives
    def checkpoints():
        state = straight.state
        sink = []
        mgr = CheckpointManager(d("rotation"), keep=3,
                                log=lambda e, **f: sink.append((e, f)))
        mgr.save_step(state, 100, {"epoch": 1})
        clean_ms, size = mgr.last_save["ms"], mgr.last_save["bytes"]
        mgr.save_step(state, 200, {"epoch": 1})
        plan = FaultPlan([Fault("ckpt.state_written", "enospc_rotation",
                                at=0)])
        with plan.activate():
            mgr.save_step(state, 300, {"epoch": 1})
        enospc_ms = mgr.last_save["ms"]
        freed = [f["freed"] for e, f in sink if e == "ckpt_enospc"]
        check(freed == [["step_00000100"]]
              and [s for s, _ in mgr.step_checkpoints()] == [200, 300],
              f"resilience: ENOSPC freed {freed}, left "
              f"{mgr.step_checkpoints()}")
        kill = FaultPlan([Fault("ckpt.pre_replace", "kill", at=0)])
        with kill.activate():
            _res_raises(SimulatedKill,
                        lambda: mgr.save_step(state, 400, {"epoch": 1}))
        check(verify_manifest(d("rotation/step_00000300")),
              "resilience: the previous generation does not verify")
        restored = mgr.restore_latest(state)
        check(restored is not None
              and restored[1]["global_step"] == 300
              and _params_equal(state.params, ref),
              "resilience: the previous generation did not restore")
        recovery.update(save_ms=clean_ms, save_bytes=size,
                        enospc_save_ms=enospc_ms,
                        restore_ms=mgr.last_restore.get("ms"))
        return ({"freed": freed[0], "save_ms": clean_ms, "bytes": size,
                 "enospc_save_ms": enospc_ms,
                 "restore_ms": mgr.last_restore.get("ms"),
                 "killed_fired": kill.fired}, plan, None)

    arm("enospc_then_kill_ckpt", checkpoints)

    # 6. a drain landing at the hot swap (paged stride kernel): refused,
    #    and drained + replayed equal a serve without the fault
    def param_swap():
        base, _ = serve_timed(service(model), reqs)
        model2 = perturbed(model)
        svc = service(model)
        pub = []

        def feedback(req, result, version):
            if not pub:
                pub.append(svc.publish_params(model2, version=1))

        svc._feedback = feedback
        snap = d("swapdrain")
        plan = FaultPlan([Fault("serving.param_swap", "param_swap", at=0)])
        with plan.activate():
            drained, drain_s = serve_timed(svc, reqs, snapshot_dir=snap)
        check(pub == [True] and drained.drained
              and drained.drain_reason == "chaos_param_swap",
              f"resilience: swap drain {drained.drain_reason!r}, publish "
              f"{pub}")
        check(svc.param_version == 0 and svc._pending_publish is None
              and svc._swap_history == [] and svc._old_versions == {}
              and all(r.param_version == 0
                      for r in drained.results.values()),
              "resilience: the swap was not refused whole")
        fresh = service(model)
        t = time.perf_counter()
        restored = load_snapshot(snap, service=fresh)
        load_s = time.perf_counter() - t
        replay, replay_s = serve_timed(fresh, [])
        union = {**drained.results, **replay.results}
        bad = [r for r, res in base.results.items()
               if r not in union or not same_result(union[r], res)]
        check(not bad and union.keys() == base.results.keys(),
              f"resilience: {len(bad)} requests differ after the swap "
              "drain and replay")
        recovery.update(drain_s=drain_s, replay_s=replay_s,
                        load_snapshot_s=load_s)
        return ({"served": drained.completed, "replayed": len(restored),
                 "drain_s": drain_s, "load_snapshot_s": load_s,
                 "replay_s": replay_s, "bitwise": True}, plan, None)

    arm("param_swap_serving", param_swap)

    # 7. actor_preempt at depth 3 bound 1: the fallback to the sync
    #    schedule, one step for every batch
    def actor_preempt():
        rl = dataclasses.replace(get_preset("msrvtt_cst_consensus").rl,
                                 epochs=1, **RES_RL)
        plan = FaultPlan([Fault("rl.actor.step", "actor_preempt", at=1)])
        tr = rl_run("actor", plan, rl, rl_topology="decoupled")
        fell = _res_events(d("actor.jsonl"), "rl_actor_fallback_sync")
        rl_steps = _res_events(d("actor.jsonl"), "rl_step")
        n_batches = Batcher(ds, batch_size=TRAIN_B, max_len=mc.max_len,
                            mode="video").num_batches()
        check(len(fell) == 1 and len(rl_steps) == n_batches
              and all(np.isfinite(e["reward"]) for e in rl_steps),
              f"resilience: actor preempt fell back {len(fell)} times, "
              f"{len(rl_steps)} steps for {n_batches} batches")
        check(all(bool(torch.isfinite(p).all()) for p in tr.state.params),
              "resilience: a param is not finite after the actor preempt")
        return ({"fallback_recount": fell[0].get("recount"),
                 "rl_steps": len(rl_steps), "batches": n_batches}, plan, None)

    arm("actor_preempt_rl", actor_preempt)

    # every kernel of the arms ran on their paths
    check(total["fused_additive_attention"] > 0
          and total["fused_decode_step"] > 0
          and total["fused_decode_stride"] > 0
          and total["fused_decode_stride_paged"] > 0,
          f"resilience: a kernel of the phase never launched: {total}")
    return {"phase": "resilience", "preset": "msrvtt_cst_consensus",
            "batch": TRAIN_B, "steps_per_epoch": steps,
            "corpus_clips": data["meta"]["clips"]["train"], "arms": arms, "recovery": recovery,
            "launches": total, "wall_s": time.perf_counter() - t_phase,
            "nvidia_smi": smi}, total


# ---- phase 6e: the health monitor and the fleet merge -------------------------

HEALTH_DEVICE = "cuda"
HEALTH_INTERVAL_S = 0.1   # the watchdog's beat and poll period
HEALTH_TIMEOUT_S = 0.5    # a peer silent this long earns a strike
HEALTH_MISSES = 2         # consecutive strikes before a loss
HEALTH_XE_AT = 3          # the xe.step visit the partial preemption fires at
HEALTH_RL_AT = 2          # the rl.step visit (mid-epoch: 6 batches an epoch)
HEALTH_RECORDER = 32      # the flight recorder's ring, arms (a) and (b)


def health_config(ckpt_dir: str, rl=None, **train):
    """res_config plus the health monitor: host 0 of 2 simulated hosts,
    the short watchdog periods above."""
    cfg = res_config(ckpt_dir, rl=rl, health=True, health_sim_hosts=2,
                     health_interval_s=HEALTH_INTERVAL_S,
                     peer_timeout_s=HEALTH_TIMEOUT_S,
                     health_misses=HEALTH_MISSES)
    return cfg.override(**{f"train__{k}": v for k, v in train.items()})


def detection_bound_s() -> tuple[float, float]:
    """The watchdog's detection window after a peer's last beat: the beat
    is seen at the next poll (<= one interval), strikes start at the first
    poll past the timeout (<= one more interval) and the loss lands on the
    ``misses``-th strike; the upper end allows one interval of thread
    scheduling on top."""
    lo = HEALTH_TIMEOUT_S + (HEALTH_MISSES - 1) * HEALTH_INTERVAL_S
    hi = HEALTH_TIMEOUT_S + (HEALTH_MISSES + 2) * HEALTH_INTERVAL_S
    return lo, hi


def health_phase(model, reqs, smi: str) -> tuple[dict, dict]:
    """The strict peer-loss path through the trainer and the serve loop,
    and the fleet merge of its postmortems (module docstring, 6e) -> (its
    line, the launches of its runs)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_health_")
    try:
        return _health(root, model, reqs, smi)
    finally:
        obs_recorder.shutdown()
        tobs.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def _health(root: str, model, reqs, smi: str) -> tuple[dict, dict]:
    from cst_captioning_tpu_torch.obs import fleet
    from cst_captioning_tpu_torch.resilience import (
        Fault, FaultPlan, HealthMonitor, PeerLost, verify_manifest)
    from cst_captioning_tpu_torch.resilience import health

    t_phase = time.perf_counter()
    data = recipe_corpus(root)
    mc = get_preset("msrvtt_cst_consensus").model
    ds = CaptionDataset(data["info_json"],
                        {n: data[n] for n, _ in mc.modalities}, "train",
                        mc.max_frames)
    d = lambda name: os.path.join(root, name)  # noqa: E731
    total = dict.fromkeys(all_launches(), 0)
    arms: dict = {}
    numbers: dict = {}

    def trainer(cfg, log):
        return trainer_mod.Trainer(cfg, ds, None, log_path=log,
                                   device=HEALTH_DEVICE)

    def arm(name, fn):
        """One arm with the launch counts set to 0 just before and read
        just after."""
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        line = fn()
        torch.cuda.synchronize()
        n = all_launches()
        for k, v in n.items():
            total[k] += v
        arms[name] = {**line, "launches": n,
                      "wall_s": time.perf_counter() - t}

    def drained(tr, fn, log):
        """Run ``fn`` under the trainer -> (PeerLost, its drain event, the
        drain's step save)."""
        try:
            err = _res_raises(PeerLost, fn)
        finally:
            tr.close()
            tobs.shutdown()
        (ev,) = _res_events(log, "peer_loss_drain")
        save = [e for e in _res_events(log, "ckpt_step")
                if e["batch_index"] == ev["batch_index"]][-1]
        return err, ev, save

    def obs_on(name):
        return dict(obs=True, obs_dir=d(name),
                    recorder_steps=HEALTH_RECORDER)

    def peer_loss_bundle(obs_dir) -> dict:
        (bundle,) = [b for b in fleet.discover_bundles(obs_dir)[0]
                     if b.endswith("_peer_loss")]
        check(verify_manifest(bundle), f"health: {bundle} does not verify")
        return json.load(open(os.path.join(bundle, "meta.json")))

    # (a) partial_preempt at xe.step: drain, a verified step save, the
    #     peer_loss postmortem naming host 1, PeerLost([1])
    def xe_drain():
        cfg = health_config(d("xe"), **obs_on("xe_obs"))
        tr = trainer(cfg, d("xe.jsonl"))
        check(tr.health.survivors() == [0, 1],
              f"health: survivors {tr.health.survivors()}")
        plan = FaultPlan([Fault("xe.step", "partial_preempt",
                                at=HEALTH_XE_AT, host=1)])
        with plan.activate():
            err, ev, save = drained(tr, tr.train_xe, d("xe.jsonl"))
        check(err.hosts == [1] and ev["phase"] == "xe" and ev["lost"] == [1]
              and ev["batch_index"] == HEALTH_XE_AT + 1,
              f"health: XE drain {ev}, PeerLost hosts {err.hosts}")
        step_dir = d(f"xe/step_{ev['step']:08d}")
        check(verify_manifest(step_dir), f"health: {step_dir} does not "
              "verify")
        meta = peer_loss_bundle(d("xe_obs"))
        check(meta["lost"] == [1], f"health: bundle meta lost "
              f"{meta.get('lost')}")
        numbers["xe_drain_save_ms"] = save["ms"]
        return {"fired": plan.fired, "batch_index": ev["batch_index"],
                "step": ev["step"], "save_ms": save["ms"],
                "save_bytes": save["bytes"], "bundle_lost": meta["lost"]}

    arm("xe_drain", xe_drain)

    # (b) the strict full restart: a straight XE + RL run; the same run
    #     losing host 1 at rl.step mid-epoch drains and raises; a restart
    #     with resume="auto" and a fresh health dir ends bitwise equal
    rl = dataclasses.replace(get_preset("msrvtt_cst_consensus").rl,
                             epochs=1, pipelined=False)

    def run(name, resume="", health_dir=""):
        cfg = health_config(d(name), rl=rl, resume=resume,
                            health_dir=health_dir,
                            **obs_on(name + "_obs" + ("_resume" if resume
                                                      else "")))
        tr = trainer(cfg, d(name + ".jsonl"))
        return tr, lambda: (tr.train_xe(), tr.train_rl())

    def restart():
        tr, fn = run("straight")
        try:
            fn()
        finally:
            tr.close()
            tobs.shutdown()
        straight = [p.detach().clone() for p in tr.state.params]
        straight_step = int(tr.state.step)
        tr2, fn2 = run("partial")
        plan = FaultPlan([Fault("rl.step", "partial_preempt",
                                at=HEALTH_RL_AT, host=1)])
        with plan.activate():
            err, ev, save = drained(tr2, fn2, d("partial.jsonl"))
        check(err.hosts == [1] and ev["phase"] == "rl"
              and ev["batch_index"] == HEALTH_RL_AT + 1
              and ev["lost"] == [1],
              f"health: RL drain {ev}, PeerLost hosts {err.hosts}")
        again, fn3 = run("partial", resume="auto", health_dir=d("hb2"))
        restore_ms = again.ckpt.last_restore.get("ms")
        check(again._resume_rl_batch == HEALTH_RL_AT + 1,
              f"health: resumed at RL batch {again._resume_rl_batch}")
        try:
            fn3()
        finally:
            again.close()
            tobs.shutdown()
        check(int(again.state.step) == straight_step
              and _params_equal(again.state.params, straight),
              "health: the restarted run's params differ from the straight "
              "run's")
        check(len(_res_events(d("partial.jsonl"), "peer_lost")) == 1,
              "health: the restart's fresh monitor lost a host")
        numbers.update(rl_drain_save_ms=save["ms"], restart_restore_ms=restore_ms)
        return {"fired": plan.fired, "batch_index": ev["batch_index"],
                "step": ev["step"], "save_ms": save["ms"],
                "restore_ms": restore_ms, "steps": straight_step,
                "bitwise": True}

    arm("strict_restart", restart)

    # (c) no tombstone: a second monitor (host 1) beats on its own thread
    #     and stops; the trainer's watchdog finds the silence and drains
    def watchdog():
        cfg = health_config(d("wd"), health_dir=d("hb_wd"), epochs=3)
        tr = trainer(cfg, d("wd.jsonl"))
        peer = HealthMonitor(d("hb_wd"), host_id=1, num_hosts=2,
                             interval_s=HEALTH_INTERVAL_S,
                             timeout_s=HEALTH_TIMEOUT_S,
                             misses=HEALTH_MISSES).start()
        try:
            deadline = time.monotonic() + 30.0
            while tr.health._seen_seq.get(1) is None:
                check(time.monotonic() < deadline,
                      "health: the trainer never saw host 1 beat")
                time.sleep(HEALTH_INTERVAL_S)
            time.sleep(4 * HEALTH_INTERVAL_S)
        finally:
            peer.stop()
        last = json.load(open(os.path.join(d("hb_wd"), "host1.hb")))
        err, ev, save = drained(tr, tr.train_xe, d("wd.jsonl"))
        (lost,) = _res_events(d("wd.jsonl"), "peer_lost")
        latency = lost["ts"] - last["ts"]
        lo, hi = detection_bound_s()
        check(err.hosts == [1] and lost["reason"] == "heartbeat_timeout"
              and not os.path.exists(os.path.join(d("hb_wd"), "host1.dead"))
              and ev["phase"] == "xe",
              f"health: watchdog arm {lost}, drain {ev}")
        check(lo <= latency <= hi, f"health: detected {latency:.3f} s after "
              f"the last beat, outside [{lo:.3f}, {hi:.3f}]")
        numbers.update(detection_latency_s=latency, detection_bound_s=[lo, hi],
                       watchdog_drain_save_ms=save["ms"])
        return {"last_seq": last["seq"], "age_s": lost["age_s"],
                "detection_latency_s": latency, "bound_s": [lo, hi],
                "drain_batch_index": ev["batch_index"],
                "save_ms": save["ms"]}

    arm("watchdog_loss", watchdog)

    # (e), from (b)'s obs dir: the victim's bundle beside it, then the
    #     fleet merge and the CLI
    def fleet_merge():
        obs_dir = d("partial_obs")
        meta = peer_loss_bundle(obs_dir)
        check(meta["lost"] == [1], f"health: RL bundle lost {meta['lost']}")
        latest = fleet.select_latest(fleet.discover_bundles(obs_dir))
        ring = [r for r in obs_report.load_postmortem(latest[0])["ring"]
                if r["phase"] == "rl"]
        check(bool(ring), "health: no RL steps in the peer_loss ring")
        fr1 = obs_recorder.FlightRecorder(
            HEALTH_RECORDER, os.path.join(obs_dir, "proc1"), run=meta["run"],
            proc=1, world=2, host="simhost1")
        trip = ring[-1]["step"]
        for r in ring:
            fr1.record(r["step"], "rl", {
                "rl_loss": math.nan if r["step"] == trip
                else r.get("rl_loss", 1.0), "grad_norm": 1.0})
        check(fr1.postmortem("divergence_nonfinite", phase="rl", step=trip)
              is not None, "health: the victim's bundle was not written")
        fr1.close()
        t = time.perf_counter()
        merged = fleet.merge_bundles(obs_dir)
        merge_s = time.perf_counter() - t
        text = fleet.render_fleet(merged)
        check(merged["merged_procs"] == [0, 1]
              and merged["victim_hosts"] == [1]
              and merged["trip"]["proc"] == 1
              and merged["trip"]["step"] == trip and "[TRIP]" in text,
              f"health: fleet merge {merged['merged_procs']}, victims "
              f"{merged['victim_hosts']}, trip {merged['trip']}")
        rc, out = cli_stdout(cli_obs_report.main, ["--postmortem", obs_dir])
        check(rc == 0 and "procs merged: 2/2" in out,
              f"health: obs_report --postmortem exited {rc}")
        return {"merged_procs": merged["merged_procs"],
                "victim_hosts": merged["victim_hosts"],
                "trip": {k: merged["trip"][k]
                         for k in ("proc", "host", "phase", "step", "kinds")},
                "offset_s": merged["procs_info"][1]["offset_s"],
                "merge_s": merge_s}

    # (d) the serve loop's drain: simulate_peer_loss(1) from the feedback
    #     after DRAIN_AFTER completions, replayed equal to the undrained
    def serve_drain():
        base, _ = serve_timed(service(model), reqs)
        mon = HealthMonitor(d("hb_serve"), host_id=0, num_hosts=2).start()
        svc = service(model)
        done = []

        def feedback(req, result, version):
            done.append(req.req_id)
            if len(done) == DRAIN_AFTER:
                health.simulate_peer_loss(1)

        svc._feedback = feedback
        snap = d("serve_drain")
        before = fused_decode_stride_paged.launches
        try:
            rep, drain_s = serve_timed(svc, reqs, snapshot_dir=snap)
        finally:
            mon.stop()
        paged = fused_decode_stride_paged.launches - before
        check(rep.drained and rep.drain_reason == "peer_loss"
              and rep.snapshot_dir == snap
              and os.path.exists(os.path.join(snap, "manifest.json")),
              f"health: serve drain {rep.drain_reason!r}, snapshot "
              f"{rep.snapshot_dir}")
        check(paged >= 1, f"health: {paged} paged launches before the drain")
        fresh = service(model)
        t = time.perf_counter()
        restored = load_snapshot(snap, service=fresh)
        load_s = time.perf_counter() - t
        replay, replay_s = serve_timed(fresh, [])
        union = {**rep.results, **replay.results}
        bad = [r for r, res in base.results.items()
               if r not in union or not same_result(union[r], res)]
        check(not bad and union.keys() == base.results.keys(),
              f"health: {len(bad)} requests differ after the peer-loss "
              "drain and replay")
        numbers.update(serve_drain_s=drain_s, serve_load_snapshot_s=load_s,
                       serve_replay_s=replay_s)
        return {"served": rep.completed, "replayed": len(restored),
                "drained_launches": paged, "drain_s": drain_s,
                "load_snapshot_s": load_s, "replay_s": replay_s,
                "bitwise": True}

    arm("serve_peer_loss", serve_drain)
    arm("fleet_merge", fleet_merge)

    check(total["fused_additive_attention"] > 0
          and total["fused_decode_step"] > 0
          and total["fused_decode_stride_paged"] > 0,
          f"health: kernel 1, 2 or 4 never launched in the phase: {total}")
    return {"phase": "health", "preset": "msrvtt_cst_consensus",
            "batch": TRAIN_B, "hosts": 2, "interval_s": HEALTH_INTERVAL_S,
            "timeout_s": HEALTH_TIMEOUT_S, "misses": HEALTH_MISSES,
            "corpus_clips": data["meta"]["clips"]["train"], "arms": arms,
            "numbers": numbers, "launches": total,
            "wall_s": time.perf_counter() - t_phase,
            "nvidia_smi": smi}, total


def device_breakdown(prof, wall_ms: float) -> dict:
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")
         and e.self_device_time_total > 0),
        key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows)
    check(busy > 0, "the profiler saw no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "top": [{"kernel": k[:90], "ms": ms, "count": n}
                    for k, ms, n in rows[:12]]}


def profile_cst(trainer, state, corpus) -> dict:
    """Device time by kernel over one CST step, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    state = state.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, m = trainer.train_step(state, corpus["feats"], corpus["masks"],
                                  corpus["vids"], seed=200)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    out = device_breakdown(prof, wall_ms)
    out.update(decode_ms=m["decode_s"] * 1e3, reward_ms=m["reward_s"] * 1e3,
               update_ms=m["update_s"] * 1e3)
    return out


def profile_beam(model, corpus) -> dict:
    """Device time by kernel over one beam-5 search of 64 clips."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        beam_search(model, corpus["feats"], corpus["masks"],
                    beam_size=BEAM_W)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return device_breakdown(prof, wall_ms)


def time_in_turns(pairs: dict) -> dict:
    """{name: (kernel_fn, plain_fn)} -> {name: (kernel ms, plain ms)}:
    CUDA-event medians, each taken in turns (A B B A) so clock ramps hit
    both alike."""
    samples = {n: ([], []) for n in pairs}
    order = list(pairs)
    for name in order + order[::-1]:
        kfn, pfn = pairs[name]
        samples[name][0].extend(event_times(kfn))
        samples[name][1].extend(event_times(pfn))
    return {n: (float(np.median(k)), float(np.median(p)))
            for n, (k, p) in samples.items()}


def step_phases(fn, layers: int, beam: bool, reps: int = 10) -> dict:
    """Device ms a call of the decode-step (or, with ``beam``, the
    beam-step) kernel spends in each of its launches, from torch.profiler
    over ``reps`` calls of ``fn`` after a warm-up; ``total`` is their sum
    and ``other`` the wrapper's own device work (casts) beside them. Each
    launch must appear as often as the step runs it (``profile_calls``)."""
    want = {"q": 1, "attend": 1, "gates": layers, "cell": layers,
            "logits": 1, **({"merge": 1} if beam else {})}
    want = {k: n * reps for k, n in want.items()}

    def seen(events):
        ms = dict.fromkeys(want, 0.0)
        count = dict.fromkeys(want, 0)
        other = 0.0
        for e in events:
            if not (str(e.device_type).endswith("CUDA")
                    and e.self_device_time_total > 0):
                continue
            phase = next((v for k, v in STEP_LAUNCHES.items()
                          if k in e.key), None)
            if phase is None:
                other += e.self_device_time_total / 1e3 / reps
                continue
            ms[phase] += e.self_device_time_total / 1e3 / reps
            count[phase] += e.count
        return ms, count, other

    ms, count, other = seen(profile_calls(
        fn, reps, lambda ev: seen(ev)[1] == want))
    check(count == want, f"step launches seen by the profiler {count}, "
          f"expected {want}")
    return {**ms, "total": sum(ms.values()), "other": other}


# ---- phase 8: the recipe through the CLIs, from files ----------------------

# a template-style corpus in the port's feature format: msrvtt modalities,
# 28 frames, 200 words, 384 / 64 / 128 clips, 5 captions a clip
RECIPE_CORPUS = dict(num_videos=576, num_topics=8, vocab_words=200,
                     captions_per_video=5, caption_len=(5, 10),
                     max_frames=28, splits=(0.667, 0.112), seed=17,
                     caption_style="template", feature_noise=0.05)
RESUME_LOSS_TOL = 1e-3   # the embedding backward's atomics: not bitwise
RECIPE_DEVICE = "cuda"
INFO_KEYS = ("epoch", "xe_epochs", "phase", "batch_index", "global_step")


def recipe_corpus(root: str) -> dict:
    """The corpus through ``data.synthetic``, then its WXE weights and
    CIDEr df through ``data.preprocess``."""
    mods = dict(get_preset("msrvtt_xe_attention").model.modalities)
    t = time.perf_counter()
    paths = make_synthetic_dataset(os.path.join(root, "data"),
                                   modalities=mods, **RECIPE_CORPUS)
    info = json.load(open(paths["info_json"]))
    tok = {v["id"]: [c.split() for c in v["captions"]]
           for v in info["videos"] if v["split"] == "train"}
    paths["consensus_weights"] = os.path.join(root, "data", "weights.npz")
    np.savez(paths["consensus_weights"], **compute_consensus_weights(tok))
    paths["cider_df"] = os.path.join(root, "data", "cider_df.npz")
    compute_cider_df(tok).save(paths["cider_df"])
    splits = {s: sum(v["split"] == s for v in info["videos"])
              for s in ("train", "val", "test")}
    check(splits == {"train": 384, "val": 64, "test": 128},
          f"recipe corpus splits {splits}")
    paths["meta"] = {"clips": splits, "words": len(info["vocab"]) - 4,
                     "feature_bytes": sum(os.path.getsize(paths[n])
                                          for n in mods),
                     "write_s": time.perf_counter() - t}
    return paths


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


class BatchTap:
    """Stands in for the trainer's ``prefetch_to_device``: records every
    batch's video ids by epoch, and holds the first batch of each epoch,
    staged by the prefetch thread on its side stream, against a blocking
    copy of the same batch."""

    def __init__(self):
        self.real = prefetch_mod.prefetch_to_device
        self.epochs: list = []       # (kind, [video ids of each batch])
        self.checked = 0

    def __call__(self, it, size=2, transform=None, place=True,
                 stop_event=None, device=None):
        it = iter(it)
        first = next(it, None)
        if first is None:
            return
        want = prefetch_mod.place_blocking(transform(first), device)
        ids: list = []
        self.epochs.append(("xe" if len(want) == 6 else "rl", ids))

        def source():
            for b in itertools.chain([first], it):
                ids.append(list(b.video_ids))
                yield b

        for k, out in enumerate(self.real(source(), size, transform, place,
                                          stop_event, device)):
            if k == 0:
                check(_same(out, want), "a prefetched batch differs from "
                      "its blocking copy")
                self.checked += 1
            yield out


class ValidationTap:
    """Wraps the Evaluator's greedy decode: the decode-step launches of
    the validations against their decode steps (one lane, G=1)."""

    def __init__(self):
        self.real = evaluator_mod.greedy_decode
        self.launches = self.steps = 0

    def __call__(self, model, feats, masks, max_len=None, min_len=0):
        before = fused_decode_step.launches
        out = self.real(model, feats, masks, max_len=max_len,
                        min_len=min_len)
        self.launches += fused_decode_step.launches - before
        self.steps += decode_depth(out[0].cpu().numpy(),
                                   max_len or model.cfg.max_len)
        return out


def run_train(argv: list, log: str) -> dict:
    """``cli.train.main(argv)`` with every launch count set to 0 just
    before and read just after; -> the trainer, its events, the launches,
    the batches by epoch and the validations' decode launches."""
    tap, vtap = BatchTap(), ValidationTap()
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    with mock.patch.object(trainer_mod, "prefetch_to_device", tap), \
            mock.patch.object(evaluator_mod, "greedy_decode", vtap):
        tr = cli_train.main(argv + ["--log-jsonl", log])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n = all_launches()
    events = [json.loads(line) for line in open(log)]
    check(tap.checked == len(tap.epochs) > 0, "prefetch check missed epochs")
    return {"trainer": tr, "events": events, "launches": n, "wall_s": wall,
            "epochs": tap.epochs, "val_launches": vtap.launches,
            "val_steps": vtap.steps}


def _ev(run, name) -> list:
    return [e for e in run["events"] if e["event"] == name]


def _infos(ckpt_dir: str, name: str = "latest") -> dict:
    infos = json.load(open(os.path.join(ckpt_dir, name, "infos.json")))
    return {k: infos[k] for k in INFO_KEYS}


def _resume_gates(label, got_ids, want_ids, got_loss, want_loss, got_infos,
                  want_infos) -> float:
    check(got_ids == want_ids, f"{label}: the resumed run's batches differ")
    check(got_infos == want_infos,
          f"{label}: infos {got_infos} != {want_infos}")
    check(len(got_loss) == len(want_loss) > 0, f"{label}: step counts")
    worst = max(rel_err(a, b) for a, b in zip(got_loss, want_loss))
    check(worst <= RESUME_LOSS_TOL, f"{label}: step loss relative error "
          f"{worst:.3e} > {RESUME_LOSS_TOL}")
    return worst


def profile_rl_epoch(trainer, pipelined: bool) -> dict:
    """Device busy and idle share of one CST epoch of the trained state
    (its batches staged on the card first), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg = trainer.cfg
    state = trainer.state.clone()
    scst = SCSTTrainer(state.model, trainer.reward, cfg.rl,
                       max_len=cfg.model.max_len, guard=True)
    batcher = Batcher(trainer.train_ds, batch_size=cfg.data.batch_size,
                      max_len=cfg.model.max_len, mode="video")
    batches = list(trainer._rl_device_batches(batcher))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, ms = scst.train_epoch(state, iter(batches),
                                 lambda j: rollout_seed(1, 0, 0, j),
                                 pipelined=pipelined)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    out = device_breakdown(prof, wall_ms)
    del out["top"]
    out.update(pipelined=pipelined, steps=len(ms),
               clips_per_s=len(ms) * cfg.data.batch_size / (wall_ms / 1e3))
    return out


def meanpool_attention(trainer) -> dict:
    """Kernel 1 at M=1 (the mean-pool encoder's bank) against its plain
    version on the trained model's encoder output, float32 and bfloat16,
    within the existing tolerances."""
    model = trainer.model
    batch = next(Batcher(trainer.train_ds, batch_size=TRAIN_B,
                         max_len=model.cfg.max_len, mode="caption")
                 .epoch(shuffle=False))
    corpus = {"feats": {n: torch.from_numpy(v).to(model.device)
                        for n, v in batch.feats.items()},
              "masks": {n: torch.from_numpy(v).to(model.device)
                        for n, v in batch.feat_masks.items()}}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = attention_inputs(model, corpus, dtype, TRAIN_B)
        check(x[2].shape[1] == 1, f"mean-pool bank has {x[2].shape[1]} slots")
        res = compare_attention(x)
        emit({"phase": "kernel_check", "kernel": "fused_additive_attention",
              "shape": "meanpool_m1", "rows": x[0].shape[0], "slots": 1,
              "dtype": str(dtype)[6:], **res})
        worst = max(worst, res["max_abs_err"])
    return {"max_abs_err": worst}


def recipe_phase(smi: str) -> tuple[dict, dict]:
    """Phase 8 in a temporary directory -> (the recipe line, the launches
    of each kernel over the recipe's runs)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    try:
        return _recipe(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _recipe(root: str, smi: str) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    data = recipe_corpus(root)
    d = lambda name: os.path.join(root, name)  # noqa: E731
    files = ["--info-json", data["info_json"],
             "--feature", f"resnet={data['resnet']}"]
    common = files + [
        "--feature", f"c3d={data['c3d']}", "--device", RECIPE_DEVICE,
        "--set", "model__attention_impl='pallas'",
        "--set", "model__decode_impl='pallas'",
        "--set", "train__log_every_steps=1",
        "--set", f"data__consensus_weights='{data['consensus_weights']}'",
        "--set", f"data__cider_df='{data['cider_df']}'"]
    T = get_preset("msrvtt_cst_consensus").model.max_len
    total = dict.fromkeys(all_launches(), 0)

    def add(n):
        for k, v in n.items():
            total[k] += v

    def train(preset, ckpt, log, *extra):
        run = run_train(["--preset", preset, *common, "--set",
                         f"train__ckpt_dir='{d(ckpt)}'", *extra], d(log))
        add(run["launches"])
        return run

    # -- XE (2 epochs) then CST (1 epoch) at msrvtt_cst_consensus ---------
    a = train("msrvtt_cst_consensus", "ck_a", "a.jsonl",
              "--set", "train__epochs=2", "--set", "rl__epochs=1")
    xe_steps, rl_steps = _ev(a, "xe_step"), _ev(a, "rl_step")
    n = a["launches"]
    check(n["fused_additive_attention"] == T * (len(xe_steps)
                                                + len(rl_steps)),
          f"recipe: {n['fused_additive_attention']} attention launches for "
          f"{len(xe_steps)} XE steps and {len(rl_steps)} updates")
    cst_decode = n["fused_decode_step"] - a["val_launches"]
    cst_steps = sum(e["decode_steps"] for e in rl_steps)
    check(cst_decode == cst_steps > 0, f"recipe: {cst_decode} CST "
          f"decode-step launches for {cst_steps} decode steps")
    check(a["val_launches"] == a["val_steps"] > 0,
          f"recipe: {a['val_launches']} validation decode-step launches for "
          f"{a['val_steps']} greedy steps")
    check(n["fused_decode_stride"] == n["fused_decode_stride_paged"]
          == n["fused_beam_step"] == 0, f"recipe launched others: {n}")
    vals = _ev(a, "validate")
    check(len(vals) == 3 and all(np.isfinite(v["cider_d"]) for v in vals),
          f"recipe validations {vals}")
    for name in ("best", "latest"):
        check(os.path.exists(os.path.join(d("ck_a"), name, "state.npz")),
              f"recipe: no {name} checkpoint")
    xe_ids = [ids for kind, ids in a["epochs"] if kind == "xe"]
    xe_loss = [e["loss"] for e in xe_steps]
    spe = len(xe_ids[0])
    # the XE phase's end: latest.prev, demoted by the CST epoch's save
    xe_infos = _infos(d("ck_a"), "latest.prev")
    saves = _ev(a, "ckpt_epoch")

    # -- resume: 1 epoch, then resume="auto" to 2 (a mid-epoch save on
    # the way), then from that mid-epoch save alone ------------------------
    no_rl = ("--set", "rl__enabled=False")
    b1 = train("msrvtt_cst_consensus", "ck_b", "b1.jsonl",
               "--set", "train__epochs=1", *no_rl)
    mid = spe + 2
    b2 = train("msrvtt_cst_consensus", "ck_b", "b2.jsonl",
               "--set", "train__epochs=2", "--set", "train__resume='auto'",
               "--set", f"train__ckpt_every_steps={mid}", *no_rl)
    ids_b = [ids for _, ids in b1["epochs"] + b2["epochs"]]
    loss_b = [e["loss"] for e in _ev(b1, "xe_step") + _ev(b2, "xe_step")]
    err_b = _resume_gates("resume", ids_b, xe_ids, loss_b, xe_loss,
                          _infos(d("ck_b")), xe_infos)
    step_ck = f"step_{mid:08d}"
    check(json.load(open(os.path.join(d("ck_b"), step_ck, "infos.json")))
          ["batch_index"] == 2, "the mid-epoch save's batch index")
    os.makedirs(d("ck_c"))
    shutil.copytree(os.path.join(d("ck_b"), step_ck),
                    os.path.join(d("ck_c"), step_ck))
    c = train("msrvtt_cst_consensus", "ck_c", "c.jsonl",
              "--set", "train__epochs=2", "--set", "train__resume='auto'",
              *no_rl)
    err_c = _resume_gates(
        "mid-epoch resume", [ids for _, ids in c["epochs"]],
        [xe_ids[1][2:]], [e["loss"] for e in _ev(c, "xe_step")],
        xe_loss[mid:], _infos(d("ck_c")), xe_infos)
    restores = [e["restore_ms"] for r in (b2, c) for e in _ev(r, "resume")]

    # -- SCST: greedy baseline from the XE best ------------------------------
    sd = train("msrvtt_scst", "ck_d", "d.jsonl", "--skip-xe",
               "--set", f"rl__init_from='{d('ck_a')}'", "--set", "rl__epochs=1")
    S = get_preset("msrvtt_scst").model.decode_stride
    s_steps = _ev(sd, "rl_step")
    strides = sum(-(-e["decode_steps"] // S) for e in s_steps)
    n = sd["launches"]
    check(n["fused_decode_stride"] == strides > 0, f"recipe SCST: "
          f"{n['fused_decode_stride']} stride launches for {strides} strides")
    check(n["fused_additive_attention"] == T * len(s_steps),
          f"recipe SCST: {n['fused_additive_attention']} attention launches "
          f"for {len(s_steps)} updates")
    check(n["fused_decode_step"] == sd["val_launches"] == sd["val_steps"],
          f"recipe SCST: decode-step launches {n} outside validation")
    check(bool(_ev(sd, "handoff")), "recipe SCST: no handoff")

    # -- eval: beam 5 on the XE best ----------------------------------------
    steps, counting = counted_beam_steps()
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    with counting, contextlib.redirect_stdout(sys.stderr):
        res = cli_eval.main(["--preset", "msrvtt_eval_beam5", *files,
                             "--feature", f"c3d={data['c3d']}",
                             "--device", RECIPE_DEVICE,
                             "--set", "model__decode_impl='pallas'",
                             "--ckpt-dir", d("ck_a"), "--ckpt-name", "best",
                             "--results-json", d("results.json")])
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t
    n = all_launches()
    add(n)
    check(n["fused_beam_step"] == steps[0] > 0, f"recipe eval: "
          f"{n['fused_beam_step']} beam-step launches for {steps[0]} steps")
    metrics = res["metrics"]
    check(len(metrics) == 8 and all(np.isfinite(v) for v in metrics.values())
          and len(res["captions"]) == 128, f"recipe eval metrics {metrics}")

    # -- mean-pool: one XE epoch of msvd_xe_meanpool -------------------------
    e = run_train(["--preset", "msvd_xe_meanpool", *files,
                   "--device", RECIPE_DEVICE,
                   "--set", "model__attention_impl='pallas'",
                   "--set", "train__epochs=1", "--set",
                   "train__log_every_steps=1",
                   "--set", f"train__ckpt_dir='{d('ck_e')}'"], d("e.jsonl"))
    add(e["launches"])
    e_steps = _ev(e, "xe_step")
    # decode_impl "xla": the validation's greedy steps run the decoder
    # cell module, whose attention is kernel 1 too
    check(e["launches"]["fused_additive_attention"]
          == e["trainer"].cfg.model.max_len * len(e_steps) + e["val_steps"]
          and e["val_steps"] > 0 and len(e_steps) > 0,
          f"mean-pool: {e['launches']} for {len(e_steps)} steps and "
          f"{e['val_steps']} validation decode steps")
    m1 = meanpool_attention(e["trainer"])

    # -- device idle share of a pipelined and a sequential CST epoch --------
    idle = {("pipelined" if p else "sequential"):
            profile_rl_epoch(a["trainer"], p) for p in (True, False)}

    rate = lambda run, name: [x["clips_per_s"] for x in _ev(run, name)]  # noqa: E731
    line = {
        "phase": "recipe", "preset": "msrvtt_cst_consensus",
        "corpus": data["meta"], "batch": a["trainer"].cfg.data.batch_size,
        "steps_per_epoch": spe,
        "xe_clips_per_s": rate(a, "xe_epoch"),
        "cst_clips_per_s": rate(a, "rl_epoch"),
        "scst_clips_per_s": rate(sd, "rl_epoch"),
        "meanpool_xe_clips_per_s": rate(e, "xe_epoch"),
        "xe_step_ms_median": [x["step_ms_median"] for x in _ev(a, "xe_epoch")],
        "cst_step_ms_median": [x["step_ms_median"]
                               for x in _ev(a, "rl_epoch")],
        "validation_ms": [v["ms"] for v in vals],
        "ckpt_save_ms": [x["ms"] for x in saves],
        "ckpt_save_bytes": [x["bytes"] for x in saves],
        "ckpt_step_save_ms": [x["ms"] for x in _ev(b2, "ckpt_step")],
        "ckpt_restore_ms": restores,
        "cst_epoch_profile": idle,
        "eval_wall_s": eval_wall, "eval_metrics": metrics,
        "cider_d_after_xe": vals[1]["cider_d"],
        "cider_d_after_cst": vals[2]["cider_d"],
        "scst_cider_d": [v["cider_d"] for v in _ev(sd, "validate")],
        "resume_loss_rel_err": err_b, "mid_epoch_resume_loss_rel_err": err_c,
        "meanpool_attention_max_abs_err": m1["max_abs_err"],
        "launches": dict(total), "wall_s": time.perf_counter() - t0,
        "nvidia_smi": smi}
    return line, total


# ---- phase 3b: the serving lifecycle ------------------------------------------

DRAIN_AFTER = 16          # completions before the SIGTERM
GROUP = 8                 # admit_group of the grouped-admission serve


def counted_strides(svc) -> list:
    """Wraps ``svc._run_stride``: the count of live parameter versions at
    each stride, read from the service's lanes before the launch."""
    pairs: list = []
    run = svc._run_stride

    def counted(report, now):
        pairs.append(len({t.param_version for t in svc._inflight.values()}))
        run(report, now)

    svc._run_stride = counted
    return pairs


def same_result(a, b) -> bool:
    return (np.array_equal(a.tokens, b.tokens)
            and np.array_equal(a.logprobs, b.logprobs))


def perturbed(model, seed: int = 7):
    """The same model with seeded noise on its output bias: a second
    parameter version whose captions differ."""
    m = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        m.cell.out_proj.bias += torch.randn(
            m.cell.out_proj.bias.shape, generator=g).to(m.device)
    return m


def lifecycle_swap(model, reqs) -> tuple[dict, list]:
    """A hot swap published from the first completion's feedback."""
    model2 = perturbed(model)
    svc = service(model)
    pub = []

    def feedback(req, result, version):
        if not pub:
            pub.append(svc.publish_params(model2, version=1))

    svc._feedback = feedback
    pairs = counted_strides(svc)
    ops.reset_launches()
    rep, wall = serve_timed(svc, reqs)
    launches = fused_decode_stride_paged.launches
    check_results(rep, model.cfg)
    check(pub == [True], f"hot swap: publish {pub}")
    by_ver = {v: [r for r, res in rep.results.items()
                  if res.param_version == v] for v in (0, 1)}
    check(all(by_ver.values()), f"hot swap: requests by version "
          f"{ {v: len(r) for v, r in by_ver.items()} }")
    check(launches == sum(pairs), f"hot swap: {launches} paged launches for "
          f"{sum(pairs)} (stride, live version) pairs")
    check(svc._old_versions == {} and svc.param_version == 1,
          "hot swap: the old version was not retired")
    alone = {}
    for req in reqs:
        res = rep.results[req.req_id]
        alone[req.req_id] = service(
            (model, model2)[res.param_version]).serve([req]).results[
                req.req_id]
        check(same_result(res, alone[req.req_id]),
              f"hot swap: {req.req_id} differs from itself served alone "
              f"under version {res.param_version}")
    differ = sum(not np.array_equal(
        alone[r].tokens, service(model).serve(
            [q for q in reqs if q.req_id == r]).results[r].tokens)
        for r in by_ver[1])
    check(differ > 0, "hot swap: version 1 captions equal version 0's")
    line = {"requests_by_version": {str(v): len(r)
                                    for v, r in by_ver.items()},
            "strides": rep.strides, "mixed_strides": sum(p > 1 for p in pairs),
            "launches": launches, "version_pairs": sum(pairs),
            "v1_captions_changed": differ, "wall_s": wall}
    return line, [r.latency_s for r in alone.values()]


def lifecycle_drain(model, reqs, base, root) -> dict:
    """SIGTERM from the feedback after DRAIN_AFTER completions, then the
    snapshot replayed on a capacity-16 service grown to 32."""
    import signal

    svc = service(model)
    done = []

    def feedback(req, result, version):
        done.append(req.req_id)
        if len(done) == DRAIN_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)

    svc._feedback = feedback
    snap = os.path.join(root, "drain")
    ops.reset_launches()
    drained, wall = serve_timed(svc, reqs, snapshot_dir=snap)
    check(drained.drained and drained.drain_reason == "sigterm",
          f"drain: drained={drained.drained} reason={drained.drain_reason!r}")
    check(os.path.exists(os.path.join(snap, "manifest.json"))
          and os.path.exists(os.path.join(snap, "queue.npz")),
          "drain: no snapshot")
    fresh = CaptionService(model, capacity=CAPACITY // 2, num_rollouts=K,
                           stride=S, frame_bucket=FRAME_BUCKET, device=SERVE_DEVICE)
    t = time.perf_counter()
    restored = load_snapshot(snap, service=fresh, grow_to=CAPACITY)
    load_s = time.perf_counter() - t
    check(fresh.B == CAPACITY and len(restored) == N_REQUESTS
          - drained.completed, f"replay: {len(restored)} requests, B={fresh.B}")
    replay, replay_wall = serve_timed(fresh, [])
    union = {**drained.results, **replay.results}
    check(union.keys() == base.results.keys(), "replay: requests lost")
    bad = [r for r, res in base.results.items()
           if not same_result(union[r], res)]
    check(not bad, f"replay: {len(bad)} requests differ from the undrained "
          f"serve: {bad[:4]}")
    return {"completed_before_drain": drained.completed,
            "replayed": len(restored), "drain_wall_s": wall,
            "snapshot_bytes": sum(os.path.getsize(os.path.join(snap, f))
                                  for f in os.listdir(snap)),
            "load_snapshot_s": load_s, "replay_wall_s": replay_wall,
            "launches": fused_decode_stride_paged.launches}


def lifecycle_grouped(model, reqs) -> dict:
    """admit_group=GROUP on a float32 copy against solo admission; the
    bfloat16 service falls back to one request an encoder pass."""
    m32 = CaptionModel(dataclasses.replace(model.cfg, dtype="float32"),
                       device=SERVE_DEVICE)
    m32.load_state_dict(model.state_dict())
    m32.eval()
    passes = {}
    reps = {}
    for g in (1, GROUP):
        svc = service(m32, admit_group=g)
        calls = []
        enc = svc._encode_batch
        svc._encode_batch = lambda r, F, enc=enc, calls=calls: (
            calls.append(len(r)), enc(r, F))[1]
        reps[g], _ = serve_timed(svc, reqs)
        passes[g] = calls
    check(max(passes[GROUP]) > 1, f"grouped: encoder passes {passes[GROUP]}")
    solo, grouped = reps[1], reps[GROUP]
    differ = [r for r, res in solo.results.items()
              if not same_result(res, grouped.results[r])]
    tok_equal = np.mean([np.array_equal(res.tokens, grouped.results[r].tokens)
                         for r, res in solo.results.items()])
    max_lp = max(float(np.abs(res.logprobs - grouped.results[r].logprobs)
                       .max()) for r, res in solo.results.items())
    check(tok_equal >= AGREE, f"grouped: {tok_equal:.3f} of requests with "
          f"solo admission's tokens < {AGREE}")
    bf = service(model, admit_group=GROUP)
    check((bf.requested_admit_group, bf.admit_group) == (GROUP, 1),
          f"grouped: the {model.cfg.dtype} service kept admit_group "
          f"{bf.admit_group}")
    return {"admit_group": GROUP, "encoder_passes_solo": len(passes[1]),
            "encoder_passes_grouped": len(passes[GROUP]),
            "requests_differing": len(differ),
            "tokens_equal_share": float(tok_equal),
            "max_logprob_diff": max_lp,
            "bf16_admit_group": bf.admit_group}


def lifecycle_policies(model, reqs) -> dict:
    """static_batch_serve beside the continuous engine on the burst."""
    static_batch_serve(model, reqs[:CAPACITY], capacity=CAPACITY,
                       num_rollouts=K, device=SERVE_DEVICE)     # warm-up
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    st = static_batch_serve(model, reqs, capacity=CAPACITY, num_rollouts=K,
                            device=SERVE_DEVICE)
    torch.cuda.synchronize()
    st_wall = time.perf_counter() - t
    st_launches = fused_decode_stride.launches
    check(st.completed == N_REQUESTS and st_launches > 0,
          f"static: {st.completed} completed, {st_launches} launches")
    for rid, res in st.results.items():
        check(res.tokens.shape == (1 + K, model.cfg.max_len)
              and np.isfinite(res.logprobs).all(), f"static: {rid} result")
    cont, c_wall = serve_timed(service(model), reqs)

    def lat(rep):
        x = np.array([r.latency_s for r in rep.results.values()])
        return float(np.percentile(x, 50)), float(np.percentile(x, 99))

    return {"static": {"requests_per_s": N_REQUESTS / st_wall,
                       "p50_latency_s": lat(st)[0],
                       "p99_latency_s": lat(st)[1], "wall_s": st_wall,
                       "dense_launches": st_launches},
            "continuous": {"requests_per_s": N_REQUESTS / c_wall,
                           "p50_latency_s": lat(cont)[0],
                           "p99_latency_s": lat(cont)[1], "wall_s": c_wall}}


def serve_lifecycle_phase(model, reqs, smi) -> tuple[dict, dict]:
    """Phase 3b -> (its line, the stride launches of its serves)."""
    t0 = time.perf_counter()
    total = {"fused_decode_stride_paged": 0, "fused_decode_stride": 0}

    def add():
        total["fused_decode_stride_paged"] += fused_decode_stride_paged.launches
        total["fused_decode_stride"] += fused_decode_stride.launches
        ops.reset_launches()

    ops.reset_launches()
    base, _ = serve_timed(service(model), reqs)
    add()
    swap, solo_lat = lifecycle_swap(model, reqs)
    add()
    root = tempfile.mkdtemp(prefix="chip_smoke_drain_")
    try:
        drain = lifecycle_drain(model, reqs, base, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    add()
    grouped = lifecycle_grouped(model, reqs)
    add()
    policies = lifecycle_policies(model, reqs)
    add()
    target = 2 * float(np.median(solo_lat))
    svc = service(model)
    svc.set_slo(target)
    rep, _ = serve_timed(svc, reqs)
    add()
    slo = {**svc.slo_snapshot(), "breaches": svc._slo.breaches,
           "median_solo_latency_s": target / 2,
           "p50_latency_s": float(np.median([r.latency_s for r in
                                             rep.results.values()]))}
    return {"phase": "serve_lifecycle", "preset": "msrvtt_xe_attention",
            "capacity": CAPACITY, "K": K, "stride": S,
            "requests": N_REQUESTS, "hot_swap": swap, "drain": drain,
            "grouped_admission": grouped, "policies": policies, "slo": slo,
            "launches": dict(total), "wall_s": time.perf_counter() - t0,
            "nvidia_smi": smi}, total


# ---- phase 3c: the composite serving stride ------------------------------------

COMPOSITE_MIN_LEN = 3     # arm (b)'s min_len
COMPOSITE_SOLO = 8        # arm (b)'s requests served alone and offline
COMPOSITE_ONLINE = 32     # arm (e)'s requests: two learner batches of 16
# arm (b)'s gates, at what the card showed (PERF.md §6): a request
# mid-flight is bitwise itself alone at the same capacity; against the
# offline B=1 decode its tokens are equal and its logprobs within TOL
# (cuBLAS sums in another order at one row)
COMPOSITE_ALONE = 1.0
COMPOSITE_OFFLINE_TOKENS = 1.0


def composite_model(dev, **over):
    """The serving model as the preset has it (decode_impl and
    attention_impl "xla", bfloat16 compute) with phase 3's weights;
    ``over`` replaces config fields (arm (d): attention_impl)."""
    cfg = dataclasses.replace(get_preset("msrvtt_xe_attention").model, **over)
    model = CaptionModel(cfg, device=dev)
    return load_flax_params(model, random_flax_params(cfg, seed=0,
                                                      eos_bias=2.0)).eval()


def row_agreement(got, want, lanes=None) -> float:
    """Share of (request, lane) token rows equal between two reports, over
    ``lanes`` (default every lane of ``got``)."""
    eq = [np.array_equal(res.tokens[g], want.results[r].tokens[g])
          for r, res in got.results.items()
          for g in (lanes if lanes is not None else range(len(res.tokens)))]
    return float(np.mean(eq))


def stride_launches() -> int:
    return fused_decode_stride.launches + fused_decode_stride_paged.launches


def latency_line(rep, wall: float) -> dict:
    lat = np.array([r.latency_s for r in rep.results.values()])
    return {"requests_per_s": len(rep.results) / wall, "wall_s": wall,
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p99_latency_s": float(np.percentile(lat, 99)),
            "strides": rep.strides}


def offline_alone(model, req, Kr: int, min_len: int):
    """``req`` decoded offline alone (B=1) through ``fused_decode`` at its
    padded frame count, on the service's counter noise -> (tokens [G, T],
    logprobs [G, T])."""
    dev = model.device
    F = -(-req.num_frames // FRAME_BUCKET) * FRAME_BUCKET
    feats = {n: torch.from_numpy(np.pad(
        np.asarray(req.feats[n], np.float32),
        ((0, F - req.num_frames), (0, 0)))[None]).to(dev)
        for n, _ in model.cfg.modalities}
    masks = {n: torch.from_numpy(np.pad(
        np.asarray(req.masks[n], np.float32),
        ((0, F - req.num_frames),))[None]).to(dev)
        for n, _ in model.cfg.modalities}
    seed = torch.tensor([req.seed], device=dev)
    V = model.cfg.vocab_size

    def noise(t):
        ts = torch.full((1, 1), t, dtype=torch.int64, device=dev)
        return counter_gumbel_noise(seed, ts, Kr, V)[0]

    g, gl, sm, sl = decoding_fused.fused_decode(
        model, feats, masks, num_rollouts=Kr, min_len=min_len,
        decode_stride=S, noise_fn=noise)
    tok = torch.cat([g[None], sm])[:, 0].cpu().numpy()
    lp = torch.cat([gl[None], sl])[:, 0].cpu().numpy()
    return tok, lp


def composite_online(model) -> dict:
    """Arm (e): an OnlineSCSTTrainer on a composite service (msrvtt_scst's
    K and reward, batches of 16, a publish after each update) over
    COMPOSITE_ONLINE requests named after clips of a seeded corpus."""
    scfg = scst_config()
    rl = dataclasses.replace(scfg.rl, **ONLINE_RL)
    host = make_corpus(model.cfg, COMPOSITE_ONLINE, 5, seed=0)
    reqs = online_requests(host, model.cfg, COMPOSITE_ONLINE)
    reward = RewardComputer(
        host["vocab"], host["gts"], cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads)
    learner = copy.deepcopy(model)
    state = create_train_state(
        learner, make_optimizer(scfg.train, 1, lr_override=rl.lr),
        seed=scfg.train.seed)
    trainer = OnlineSCSTTrainer(learner, reward, rl, state, guard=True,
                                ref_id=lambda r: r.req_id.split("#")[0])
    svc = service(model, num_rollouts=rl.num_rollouts)
    trainer.attach(svc)
    ops.reset_launches()
    rep, wall = serve_timed(svc, reqs)
    trainer.flush()
    n_stride = stride_launches()
    check(rep.completed == COMPOSITE_ONLINE,
          f"serve_composite (e): {rep.completed} of {COMPOSITE_ONLINE} "
          "requests completed")
    check(trainer.last_applied >= 1 and len(svc._swap_history) >= 1,
          f"serve_composite (e): {trainer.last_applied} updates, "
          f"{len(svc._swap_history)} publishes swapped in")
    check(n_stride == 0, f"serve_composite (e): {n_stride} stride launches")
    check(all(np.isfinite(m["rl_loss"]) for m in trainer.history),
          "serve_composite (e): a non-finite rl_loss")
    return {"requests": COMPOSITE_ONLINE, "rollouts": rl.num_rollouts,
            "updates": trainer.last_applied, "dropped": trainer.last_dropped,
            "publishes_swapped": len(svc._swap_history),
            "param_versions": sorted({r.param_version
                                      for r in rep.results.values()}),
            "reward_mean": [m["reward_mean"] for m in trainer.history],
            **latency_line(rep, wall), "launches": all_launches()}


def serve_composite_phase(reqs, kernel_rep, smi) -> tuple[dict, dict]:
    """Phase 3c (module docstring) on phase 3's burst, against phase 3's
    kernel serve ``kernel_rep`` -> (its line, kernel 1's launches)."""
    t0 = time.perf_counter()
    dev = torch.device(SERVE_DEVICE)
    model = composite_model(dev)
    cfg = model.cfg
    check(cfg.decode_impl == "xla" and cfg.attention_impl == "xla",
          f"serve_composite: the preset's model has decode_impl "
          f"{cfg.decode_impl!r}, attention_impl {cfg.attention_impl!r}")
    service(model).serve(reqs[:4])                  # first-call costs
    # (a) K=2 beside phase 3's kernel serve
    svc = service(model)
    check(not svc.use_kernel and not svc.paged and svc.device.type == "cuda",
          f"serve_composite: use_kernel {svc.use_kernel}, paged "
          f"{svc.paged}, device {svc.device}")
    ops.reset_launches()
    rep_a, wall_a = serve_timed(svc, reqs)
    launched = all_launches()
    check_results(rep_a, cfg)
    check(not any(launched.values()), f"serve_composite (a): {launched}")
    check(svc._lanes.token.device.type == "cuda",
          "serve_composite (a): the lanes left the card")
    agree_a = row_agreement(rep_a, kernel_rep)
    check(agree_a >= AGREE, f"serve_composite (a): {agree_a:.3f} of rows "
          f"equal to the kernel serve's < {AGREE}")
    gen = int(sum((r.tokens != PAD_ID).sum() for r in rep_a.results.values()))
    arm_a = {**latency_line(rep_a, wall_a), "tokens_per_s": gen / wall_a,
             "kernel_serve_agreement": agree_a, "launches": launched}
    # (b) per-row min_len; mid-flight against alone and against offline
    ops.reset_launches()
    rep_b, wall_b = serve_timed(service(model, min_len=COMPOSITE_MIN_LEN),
                                reqs)
    early = [r for r, res in rep_b.results.items()
             if ((res.tokens[:, :COMPOSITE_MIN_LEN] == EOS_ID)
                 | (res.tokens[:, :COMPOSITE_MIN_LEN] == PAD_ID)).any()]
    check(rep_b.completed == N_REQUESTS and not early,
          f"serve_composite (b): {rep_b.completed} completed, EOS before "
          f"step {COMPOSITE_MIN_LEN} in {early[:4]}")
    alone_eq, offline_eq, offline_tok_eq, offline_lp = [], [], [], 0.0
    for req in reqs[:COMPOSITE_SOLO]:
        res = rep_b.results[req.req_id]
        alone = service(model, min_len=COMPOSITE_MIN_LEN).serve(
            [req]).results[req.req_id]
        alone_eq.append(same_result(res, alone))
        tok, lp = offline_alone(model, req, K, COMPOSITE_MIN_LEN)
        offline_eq.append(np.array_equal(res.tokens, tok)
                          and np.array_equal(res.logprobs, lp))
        offline_tok_eq.append(np.array_equal(res.tokens, tok))
        if offline_tok_eq[-1]:
            offline_lp = max(offline_lp,
                             float(np.abs(res.logprobs - lp).max()))
    alone_share = float(np.mean(alone_eq))
    check(alone_share >= COMPOSITE_ALONE,
          f"serve_composite (b): {alone_share:.3f} of requests bitwise "
          f"equal to themselves alone < {COMPOSITE_ALONE}")
    offline_share = float(np.mean(offline_tok_eq))
    check(offline_share >= COMPOSITE_OFFLINE_TOKENS and offline_lp <= TOL,
          f"serve_composite (b): {offline_share:.3f} of requests with the "
          f"offline decode's tokens < {COMPOSITE_OFFLINE_TOKENS}, or their "
          f"logprobs {offline_lp:.3e} apart > {TOL}")
    check(stride_launches() == 0,
          f"serve_composite (b): {stride_launches()} stride launches")
    arm_b = {"min_len": COMPOSITE_MIN_LEN, **latency_line(rep_b, wall_b),
             "solo_requests": COMPOSITE_SOLO,
             "alone_bitwise_share": alone_share,
             "offline_bitwise_share": float(np.mean(offline_eq)),
             "offline_tokens_equal_share": offline_share,
             "offline_max_logprob_diff": offline_lp}
    # (c) greedy-only lanes
    ops.reset_launches()
    rep_c, wall_c = serve_timed(service(model, num_rollouts=0), reqs)
    check(rep_c.completed == N_REQUESTS and all(
        r.tokens.shape == (1, cfg.max_len) and r.best_lane == 0
        for r in rep_c.results.values()),
          f"serve_composite (c): {rep_c.completed} completed")
    agree_c = row_agreement(rep_c, rep_a, lanes=(0,))
    check(agree_c >= AGREE and stride_launches() == 0,
          f"serve_composite (c): {agree_c:.3f} of greedy rows equal to "
          f"(a)'s lane 0, {stride_launches()} stride launches")
    arm_c = {**latency_line(rep_c, wall_c), "lane0_agreement": agree_c}
    # (d) kernel 1 in the decode cell
    pal = composite_model(dev, attention_impl="pallas")
    service(pal).serve(reqs[:4])
    svc_d = service(pal)
    ops.reset_launches()
    rep_d, wall_d = serve_timed(svc_d, reqs)
    att = fused_additive_attention.launches
    want = rep_d.strides * svc_d.S * svc_d.G
    check(att == want and stride_launches() == 0,
          f"serve_composite (d): {att} attention launches for "
          f"{rep_d.strides} strides x S={svc_d.S} x G={svc_d.G} = {want}, "
          f"{stride_launches()} stride launches")
    agree_d = row_agreement(rep_d, rep_a)
    check(agree_d >= AGREE, f"serve_composite (d): {agree_d:.3f} of rows "
          f"equal to (a)'s < {AGREE}")
    arm_d = {**latency_line(rep_d, wall_d), "attention_launches": att,
             "xla_agreement": agree_d}
    del pal, svc_d
    # (e) the online learner on a composite service
    arm_e = composite_online(model)
    return {"phase": "serve_composite", "preset": "msrvtt_xe_attention",
            "dtype": cfg.dtype, "capacity": CAPACITY, "K": K, "stride": S,
            "frame_bucket": FRAME_BUCKET, "requests": N_REQUESTS,
            "a_k2": arm_a, "b_min_len": arm_b, "c_greedy_only": arm_c,
            "d_attention_kernel": arm_d, "e_online": arm_e,
            "phase_s": time.perf_counter() - t0, "nvidia_smi": smi}, {
                "fused_additive_attention": att}


# ---- phase 8b: importing a distribution ------------------------------------------

IMPORT_CLIPS = (96, 16, 16)   # MSR-VTT train / validate / test
MSVD_CLIPS = (48, 8, 8)
IMPORT_CAPTIONS = 20
TOPICS = [("man", "playing", "a guitar"), ("woman", "cooking", "some soup"),
          ("dog", "running", "across a yard"), ("child", "riding", "a bike"),
          ("cat", "chasing", "a ball"), ("chef", "slicing", "vegetables"),
          ("girl", "singing", "on a stage"), ("player", "kicking", "a ball")]


def template_captions(rng, topic: int, n: int) -> list:
    subj, verb, obj = TOPICS[topic]
    lead = ("a", "the", "one", "a young", "an old")
    tail = ("", " outside", " indoors", " slowly", " again")
    return [f"{rng.choice(lead)} {subj} is {verb} {obj}{rng.choice(tail)}"
            for _ in range(n)]


def write_clip_features(root: str, clips: list, topics: list, dims: dict,
                        rng) -> dict:
    """<clip>.npy [max_frames, dim] float32 a modality: a topic's centre
    plus noise, so the features predict the captions."""
    F = get_preset("msrvtt_xe_attention").model.max_frames
    out = {}
    for name, dim in dims.items():
        d = os.path.join(root, f"{name}_npy")
        os.makedirs(d)
        centres = rng.normal(size=(len(TOPICS), dim)).astype(np.float32)
        for clip, topic in zip(clips, topics):
            np.save(os.path.join(d, f"{clip}.npy"), centres[topic]
                    + 0.05 * rng.normal(size=(F, dim)).astype(np.float32))
        out[name] = d
    return out


def import_sources(root: str) -> dict:
    """An MSR-VTT distribution (videodatainfo.json, <video_id>.npy for
    resnet and c3d) and an MSVD one (video_corpus.csv, youtube_mapping.txt,
    resnet only) under ``root``."""
    rng = np.random.default_rng(23)
    mods = dict(get_preset("msrvtt_xe_attention").model.modalities)
    n = sum(IMPORT_CLIPS)
    vids = [f"video{i}" for i in range(n)]
    topics = [i % len(TOPICS) for i in range(n)]
    split = ["train"] * IMPORT_CLIPS[0] + ["validate"] * IMPORT_CLIPS[1] + [
        "test"] * IMPORT_CLIPS[2]
    sentences = [{"video_id": v, "caption": c, "sen_id": k}
                 for v, tp in zip(vids, topics)
                 for k, c in enumerate(template_captions(rng, tp,
                                                         IMPORT_CAPTIONS))]
    info = os.path.join(root, "videodatainfo.json")
    with open(info, "w") as f:
        json.dump({"videos": [{"video_id": v, "split": s, "category": tp}
                              for v, s, tp in zip(vids, split, topics)],
                   "sentences": sentences}, f)
    msrvtt_feats = write_clip_features(os.path.join(root, "msrvtt"), vids,
                                       topics, mods, rng)
    m = sum(MSVD_CLIPS)
    clips = [f"yt{i:03d}_{i * 7}_{i * 7 + 5}" for i in range(m)]
    mtopics = [i % len(TOPICS) for i in range(m)]
    corpus = os.path.join(root, "video_corpus.csv")
    with open(corpus, "w") as f:
        f.write("VideoID,Start,End,WorkerID,Source,AnnotationTime,"
                "Language,Description\n")
        for i, (clip, tp) in enumerate(zip(clips, mtopics)):
            vid, start, end = f"yt{i:03d}", i * 7, i * 7 + 5
            for j, c in enumerate(template_captions(rng, tp, 10)):
                f.write(f"{vid},{start},{end},w{j},x,1,English,{c}\n")
            f.write(f"{vid},{start},{end},w9,x,1,German,eine katze\n")
    mapping = os.path.join(root, "youtube_mapping.txt")
    with open(mapping, "w") as f:
        for i in reversed(range(m)):
            f.write(f"{clips[i]} vid{i + 1}\n")
    msvd_feats = write_clip_features(os.path.join(root, "msvd"), clips,
                                     mtopics, {"resnet": mods["resnet"]}, rng)
    captions = os.path.join(root, "captions.json")
    with open(captions, "w") as f:
        json.dump({"videos": [
            {"id": v, "split": {"validate": "val"}.get(s, s),
             "captions": [x["caption"] for x in sentences[
                 k * IMPORT_CAPTIONS:(k + 1) * IMPORT_CAPTIONS]]}
            for k, (v, s) in enumerate(zip(vids, split))]}, f)
    return {"info": info, "msrvtt": msrvtt_feats, "corpus": corpus,
            "mapping": mapping, "msvd": msvd_feats, "captions": captions,
            "feature_bytes": sum(
                os.path.getsize(os.path.join(d, x))
                for d in (*msrvtt_feats.values(), *msvd_feats.values())
                for x in os.listdir(d))}


def cli_json(main, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue())


def import_phase(smi: str) -> tuple[dict, dict]:
    """Phase 8b in a temporary directory -> (its line, the launches)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_import_")
    try:
        return _import(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _import(root: str, smi: str) -> tuple[dict, dict]:
    wall = {}
    t = time.perf_counter()
    src = import_sources(root)
    wall["write_sources_s"] = time.perf_counter() - t
    d = lambda name: os.path.join(root, name)  # noqa: E731
    t = time.perf_counter()
    mv = cli_json(cli_import_msrvtt.main, [
        "--videodatainfo", src["info"], "--out-dir", d("msrvtt_out"),
        *[a for n, p in src["msrvtt"].items()
          for a in ("--feature", f"{n}={p}")]])
    wall["import_msrvtt_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ms = cli_json(cli_import_msvd.main, [
        "--corpus", src["corpus"], "--mapping", src["mapping"],
        "--out-dir", d("msvd_out"), "--feature",
        f"resnet={src['msvd']['resnet']}", "--n-train", str(MSVD_CLIPS[0]),
        "--n-val", str(MSVD_CLIPS[1])])
    wall["import_msvd_s"] = time.perf_counter() - t
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_preprocess.main(["--captions", src["captions"], "--out-dir",
                             d("pre_out")])
    wall["preprocess_s"] = time.perf_counter() - t
    # every output loads through CaptionDataset
    F = get_preset("msrvtt_xe_attention").model.max_frames
    t = time.perf_counter()
    loaded = {}
    for label, paths, want in (
            ("msrvtt", mv, IMPORT_CLIPS), ("msvd", ms, MSVD_CLIPS),
            ("preprocess", {"info_json": d("pre_out/info.json"),
                            "consensus_weights":
                                d("pre_out/consensus_weights.npz"),
                            "feature_files": mv["feature_files"]},
             IMPORT_CLIPS)):
        for split, n in zip(("train", "val", "test"), want):
            ds = CaptionDataset(paths["info_json"], paths["feature_files"],
                                split, max_frames=F,
                                consensus_weights=paths["consensus_weights"])
            check(len(ds) == n, f"import {label} {split}: {len(ds)} clips")
            feats = ds.features_for(ds.records[0].video_id)
            check(all(f.shape == (F, dict(
                get_preset("msrvtt_xe_attention").model.modalities)[k])
                and m.sum() == F for k, (f, m) in feats.items()),
                f"import {label} {split}: feature shapes")
            loaded[f"{label}_{split}"] = len(ds)
            ds.close()
    check(CorpusDF.load(mv["cider_df"]).num_docs == IMPORT_CLIPS[0],
          "import: the df's documents")
    wall["load_s"] = time.perf_counter() - t
    # one XE epoch at msrvtt_cst_consensus from the imported directory
    T = get_preset("msrvtt_cst_consensus").model.max_len
    ck = d("ck")
    t = time.perf_counter()
    run = run_train([
        "--preset", "msrvtt_cst_consensus", "--info-json", mv["info_json"],
        *[a for n, p in mv["feature_files"].items()
          for a in ("--feature", f"{n}={p}")],
        "--device", RECIPE_DEVICE,
        "--set", "model__attention_impl='pallas'",
        "--set", "model__decode_impl='pallas'",
        "--set", "train__epochs=1", "--set", "rl__enabled=False",
        "--set", "train__log_every_steps=1",
        "--set", f"data__consensus_weights='{mv['consensus_weights']}'",
        "--set", f"data__cider_df='{mv['cider_df']}'",
        "--set", f"train__ckpt_dir='{ck}'"], d("train.jsonl"))
    wall["train_xe_epoch_s"] = time.perf_counter() - t
    steps = _ev(run, "xe_step")
    n = run["launches"]
    check(n["fused_additive_attention"] == T * len(steps) > 0,
          f"import train: {n['fused_additive_attention']} attention launches "
          f"for {len(steps)} XE steps")
    check(n["fused_decode_step"] == run["val_launches"] == run["val_steps"]
          > 0, f"import train: {n['fused_decode_step']} decode-step launches, "
          f"{run['val_steps']} greedy validation steps")
    vals = _ev(run, "validate")
    check(len(vals) == 1 and np.isfinite(vals[0]["cider_d"]),
          f"import train: validations {vals}")
    # the best checkpoint published into a live service mid-serve
    t = time.perf_counter()
    mcfg = dataclasses.replace(run["trainer"].cfg.model, decode_impl="pallas",
                               decode_stride=S)
    torch.manual_seed(0)
    live = CaptionModel(mcfg, device=RECIPE_DEVICE).eval()
    trained = ckpt_load_params(ck, "best",
                               CaptionModel(mcfg, device=RECIPE_DEVICE).eval())
    test = CaptionDataset(mv["info_json"], mv["feature_files"], "test",
                          max_frames=F)
    reqs = []
    for k, rec in enumerate(test.records):
        fm = test.features_for(rec.video_id)
        reqs.append(ClipRequest(rec.video_id,
                                {m: f for m, (f, _) in fm.items()},
                                {m: mk for m, (_, mk) in fm.items()},
                                seed=k))
    test.close()
    svc = CaptionService(live, test.vocab, capacity=4, num_rollouts=K,
                         stride=S, frame_bucket=FRAME_BUCKET, device=RECIPE_DEVICE)
    admitted = []
    bind = svc._bind_lane

    def record_bind(ticket):
        admitted.append((ticket.req.req_id, svc.param_version))
        bind(ticket)

    svc._bind_lane = record_bind
    pub = []

    def feedback(req, result, version):
        if not pub:
            pub.append(svc.publish_params(trained))

    svc._feedback = feedback
    ops.reset_launches()
    rep, _ = serve_timed(svc, reqs)
    serve_launches = fused_decode_stride_paged.launches
    after = [r for r, v in admitted if v == 1]
    check(pub == [True] and rep.completed == len(reqs) and after
          and all(rep.results[r].param_version == 1 for r in after)
          and all(rep.results[r].param_version == 0
                  for r, v in admitted if v == 0),
          f"import serve: versions {[(r, rep.results[r].param_version) for r, _ in admitted]}")
    wall["publish_serve_s"] = time.perf_counter() - t
    launches = {k: v for k, v in n.items()}
    launches["fused_decode_stride_paged"] += serve_launches
    line = {"phase": "import", "sources": {
                "msrvtt_clips": IMPORT_CLIPS, "msvd_clips": MSVD_CLIPS,
                "captions_per_clip": IMPORT_CAPTIONS,
                "feature_bytes": src["feature_bytes"]},
            "loaded": loaded, "vocab_words": len(test.vocab) - 4,
            "xe_steps": len(steps), "validation_cider_d": vals[0]["cider_d"],
            "served": rep.completed, "admitted_after_swap": len(after),
            "wall_s_by_step": wall, "launches": launches,
            "nvidia_smi": smi}
    return line, launches


# ---- phase 8c: observability --------------------------------------------------

OBS_RECORDER_STEPS = 16
OBS_LOG_EVERY = 2         # the recorder's flush cadence
# the XE epochs of the overhead comparison, obs on or off, in turns
OBS_TURNS = (False, True, True, False, False, True, True, False)
ATTENTION_SYMBOL = "additive_attention_kernel"      # csrc/additive_attention.cu
STEP_SYMBOLS = ("step_attend", "step_logits")       # csrc/step.cuh
MEMORY_GAUGES = ("bytes_in_use", "peak_bytes_in_use", "reserved_bytes",
                 "peak_reserved_bytes")


def cli_stdout(main_fn, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def trace_kernels(path: str) -> set:
    """The CUDA kernel names in a torch.profiler Chrome trace."""
    return {e.get("name", "") for e in json.load(open(path))["traceEvents"]
            if e.get("cat") == "kernel"}


def last_metrics(run_dir: str) -> dict:
    return [e for e in obs_report.load_events(run_dir)
            if e["event"] == "metrics"][-1]


def host_rows(rep: dict, n: int = 8) -> list:
    """The report's foreground rows by self time, most first."""
    rows = sorted(rep["phases"], key=lambda p: -p["self_s"])[:n]
    return [{k: p[k] for k in ("phase", "count", "self_s", "pct_wall",
                               "p50_s", "max_s", "mfu")} for p in rows]


def span_durations(run_dir: str, name: str) -> list:
    return [e["dur"] for e in obs_report.load_events(run_dir)
            if e["event"] == "span" and e["name"] == name]


def verified_bundle(path: str) -> dict:
    """``cli.obs_report --postmortem`` over a bundle -> its summary."""
    rc, out = cli_stdout(cli_obs_report.main, ["--postmortem", path])
    check(rc == 0 and "manifest verified (sha256)" in out,
          f"obs: bundle {path} did not verify:\n{out}")
    pm = obs_report.load_postmortem(path)
    return {"reason": pm["meta"]["reason"], "ring_steps": len(pm["ring"]),
            "verified": pm["verified"]}


def obs_emit_cost(root: str, n: int = 2000) -> dict:
    """Host microseconds of one span with obs on (an empty ``obs.span``:
    its ``events.jsonl`` line and trace entry), and of writing such a line
    line-buffered (the stream's mode: a write call a line) and
    block-buffered, each over ``n`` in a row."""
    tobs.configure(root, run="emit_cost")
    t = time.perf_counter()
    for _ in range(n):
        with tobs.span("serving.detok", req="r0"):
            pass
    out = {"span_us": (time.perf_counter() - t) / n * 1e6}
    tobs.shutdown()
    line = open(os.path.join(root, "events.jsonl")).readlines()[1]
    for name, buffering in (("line_buffered_write_us", 1),
                            ("block_buffered_write_us", -1)):
        with open(os.path.join(root, name), "a", buffering=buffering) as f:
            t = time.perf_counter()
            for _ in range(n):
                f.write(line)
            out[name] = (time.perf_counter() - t) / n * 1e6
    return out


class RingTap:
    """Stands in for ``Trainer.close``: before the trainer shuts the flight
    recorder, keep its ring and flush count and dump
    ``recorder.postmortem("smoke")``."""

    def __init__(self):
        self.real = trainer_mod.Trainer.close
        self.ring: list = []
        self.readbacks = 0
        self.bundle = None

    def __call__(self, trainer):
        fr = obs_recorder.active()
        if fr is not None:
            fr.flush()
            self.ring = list(fr.ring)
            self.readbacks = fr.readbacks
            self.bundle = obs_recorder.postmortem("smoke")
        self.real(trainer)


def obs_phase(smi: str) -> tuple[dict, dict]:
    """Phase 8c in a temporary directory -> (its line, the launches)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        return _obs(root, smi)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        obs_recorder.shutdown()
        tobs.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def _obs(root: str, smi: str) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    dev = torch.device(RECIPE_DEVICE)
    data = recipe_corpus(root)
    d = lambda name: os.path.join(root, name)  # noqa: E731
    files = ["--info-json", data["info_json"],
             "--feature", f"resnet={data['resnet']}",
             "--feature", f"c3d={data['c3d']}"]
    total = dict.fromkeys(all_launches(), 0)

    def add(n):
        for k, v in n.items():
            total[k] += v

    # -- train and eval with obs on ------------------------------------------
    tobs.REGISTRY.reset()
    tap = RingTap()
    with mock.patch.object(trainer_mod.Trainer, "close",
                           lambda self: tap(self)):
        run = run_train([
            "--preset", "msrvtt_cst_consensus", *files,
            "--device", RECIPE_DEVICE,
            "--set", "model__attention_impl='pallas'",
            "--set", "model__decode_impl='pallas'",
            "--set", f"data__consensus_weights='{data['consensus_weights']}'",
            "--set", f"data__cider_df='{data['cider_df']}'",
            "--set", f"train__ckpt_dir='{d('ck')}'",
            "--set", "train__epochs=1", "--set", "rl__epochs=1",
            "--set", f"train__log_every_steps={OBS_LOG_EVERY}",
            "--obs", d("obs"), "--profile", d("prof"),
            "--set", f"train__recorder_steps={OBS_RECORDER_STEPS}",
            "--set", "train__anomaly=True",
            "--set", "train__profile_steps=3"], d("train.jsonl"))
    add(run["launches"])
    rc, out = cli_stdout(cli_obs_report.main, [d("obs"), "--json"])
    check(rc == 0, f"obs_report exited {rc}")
    rep = json.loads(out)
    rows = {p["phase"]: p for p in rep["phases"]}
    need = ("setup", "xe.step", "rl.decode", "rl.reward", "rl.update",
            "ckpt.save", "eval")
    check(rep["coverage"] >= 0.90 and all(n in rows for n in need),
          f"obs: coverage {rep['coverage']:.3f}, rows {sorted(rows)}")
    met = last_metrics(d("obs"))
    peak = met["gauges"]["device.peak_flops"]
    card = torch.cuda.get_device_name(0)
    check(peak == obs_flops.peak_flops(card) > 0,
          f"obs: device.peak_flops {peak} for {card!r}")
    mfu = {p: r["mfu"] for p, r in rows.items() if r["mfu"] is not None}
    check(mfu and all(math.isfinite(v) and 0 < v <= 1 for v in mfu.values()),
          f"obs: MFU rows {mfu}")
    total_mem = torch.cuda.get_device_properties(0).total_memory
    mem = {g: met["gauges"][f"device.{g}"] for g in MEMORY_GAUGES}
    check(all(0 < v <= total_mem for v in mem.values())
          and met["gauges"]["device.bytes_limit"] == total_mem,
          f"obs: memory gauges {mem} against {total_mem}")
    xe_kernels = trace_kernels(d("prof/xe/trace.json"))
    rl_kernels = trace_kernels(d("prof/rl/trace.json"))
    check(any(ATTENTION_SYMBOL in k for k in xe_kernels),
          f"obs: no {ATTENTION_SYMBOL} in the XE trace")
    check(all(any(s in k for k in rl_kernels) for s in STEP_SYMBOLS),
          f"obs: no {STEP_SYMBOLS} in the CST trace")
    steps = rows["xe.step"]["count"] + rows["rl.update"]["count"]
    ring_ok = all(
        all(math.isfinite(v) for k, v in r.items()
            if k in ("loss", "rl_loss", "grad_norm")
            or k.startswith("upd_ratio/"))
        and ("loss" in r or "rl_loss" in r)
        and sum(k.startswith("upd_ratio/") for k in r) == 5
        for r in tap.ring)
    check(len(tap.ring) == steps <= OBS_RECORDER_STEPS and ring_ok,
          f"obs: ring {len(tap.ring)} records for {steps} steps")
    bundle = verified_bundle(tap.bundle)
    check(bundle["ring_steps"] == steps, f"obs: bundle {bundle}")
    step_s = {n: span_durations(d("obs"), n)
              for n in ("xe.step", "rl.decode", "rl.update", "ckpt.save")}
    steps_b, counting = counted_beam_steps()
    ops.reset_launches()
    tobs.REGISTRY.reset()
    with counting, contextlib.redirect_stdout(io.StringIO()):
        cli_eval.main(["--preset", "msrvtt_eval_beam5", *files,
                       "--device", RECIPE_DEVICE,
                       "--set", "model__decode_impl='pallas'",
                       "--ckpt-dir", d("ck"), "--ckpt-name", "best",
                       "--results-json", d("results.json"),
                       "--obs", d("obs_eval")])
    add(all_launches())
    rc, out = cli_stdout(cli_obs_report.main, [d("obs_eval"), "--json"])
    erep = json.loads(out)
    check(rc == 0 and "eval" in {p["phase"] for p in erep["phases"]}
          and erep["eval"]["captions"] == 128,
          f"obs: eval report {erep['eval']}")
    train_s = time.perf_counter() - t0

    # -- one XE epoch, obs off and on, in turns -------------------------------
    t = time.perf_counter()
    mods = [n for n, _ in get_preset("msrvtt_cst_consensus").model.modalities]
    base = get_experiment("msrvtt_cst_consensus").override(
        model__attention_impl="pallas", model__decode_impl="pallas",
        train__epochs=1, rl__enabled=False,
        train__log_every_steps=OBS_LOG_EVERY,
        data__consensus_weights=data["consensus_weights"])
    ds = CaptionDataset(data["info_json"], {n: data[n] for n in mods},
                        "train", max_frames=base.model.max_frames,
                        consensus_weights=base.data.consensus_weights)

    def xe_epoch(on: bool, k: int) -> dict:
        extra = (dict(train__obs=True, train__obs_dir=d(f"ovh_obs{k}"),
                      train__recorder_steps=OBS_RECORDER_STEPS) if on
                 else {})
        cfg = base.override(train__ckpt_dir=d(f"ovh{k}"), **extra)
        tobs.REGISTRY.reset()
        tr = trainer_mod.Trainer(cfg, ds, None, log_path=d(f"ovh{k}.jsonl"),
                                 device=RECIPE_DEVICE)
        torch.cuda.synchronize()
        ops.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tr.train_xe()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        flushes = obs_recorder.active().readbacks if on else 0
        n = all_launches()
        tr.close()
        tobs.shutdown()
        ev = [json.loads(line) for line in open(d(f"ovh{k}.jsonl"))]
        epoch = [e for e in ev if e["event"] == "xe_epoch"][0]
        out = {"obs": on, "syncs": sum("synchroniz" in str(w.message)
                                       for w in caught),
               "flushes": flushes, "clips_per_s": epoch["clips_per_s"],
               "losses": [e["loss"] for e in ev if e["event"] == "xe_step"]
               + [epoch["loss"]], "launches": n,
               "params": [p.detach().clone() for p in tr.model.parameters()]}
        del tr
        shutil.rmtree(d(f"ovh{k}"), ignore_errors=True)
        return out

    turns = [xe_epoch(on, k) for k, on in enumerate(OBS_TURNS)]
    ds.close()
    for r in turns:
        add(r["launches"])
        check(r["losses"] == turns[0]["losses"] and all(
            torch.equal(a, b) for a, b in zip(r["params"],
                                              turns[0]["params"])),
              f"obs: the XE epoch with obs={r['obs']} is not bitwise equal "
              "to the first")
    off = [r for r in turns if not r["obs"]]
    on = [r for r in turns if r["obs"]]
    for a, b in zip(on, off):
        check(a["syncs"] - b["syncs"] <= a["flushes"],
              f"obs: {a['syncs']} syncs with obs on, {b['syncs']} off, "
              f"{a['flushes']} recorder flushes")
    med = lambda rs: float(np.median([r["clips_per_s"] for r in rs]))  # noqa: E731
    overhead = {"clips_per_s_off": [r["clips_per_s"] for r in off],
                "clips_per_s_on": [r["clips_per_s"] for r in on],
                "median_on_over_off": med(on) / med(off),
                "syncs_off": [r["syncs"] for r in off],
                "syncs_on": [r["syncs"] for r in on],
                "recorder_flushes": [r["flushes"] for r in on],
                "logged_losses": len(turns[0]["losses"]) - 1, "bitwise": True,
                "wall_s": time.perf_counter() - t}
    del turns, off, on

    # -- the serve burst with obs on, then one drain -------------------------
    t = time.perf_counter()
    model = make_model(dev)
    reqs = requests(model.cfg)
    service(model).serve(reqs[:4])      # warm-up, as the serve phase's
    serve_rps = {"off": [], "on": []}
    for k, on in enumerate((False, True, True, False)):
        tobs.REGISTRY.reset()
        if on:
            tobs.configure(d(f"obs_turn{k}"), run="serve")
        ops.reset_launches()
        _, wall = serve_timed(service(model), reqs)
        tobs.shutdown()
        total["fused_decode_stride_paged"] += \
            fused_decode_stride_paged.launches
        serve_rps["on" if on else "off"].append(N_REQUESTS / wall)
    tobs.REGISTRY.reset()
    tobs.configure(d("obs_serve"), run="serve")
    svc = service(model)
    svc.set_slo(1.0)
    ops.reset_launches()
    srep, swall = serve_timed(svc, reqs)
    paged = fused_decode_stride_paged.launches
    snap = tobs.snapshot()
    c = snap["counters"]
    funnel = {k: c.get(f"serving.requests_{k}", 0)
              for k in ("submitted", "admitted", "completed")}
    check(all(v == N_REQUESTS for v in funnel.values())
          and c["serving.strides"] == paged == srep.strides
          and snap["histograms"]["serving.latency_seconds"]["count"]
          == N_REQUESTS, f"obs serve: funnel {funnel}, strides "
          f"{c['serving.strides']}, paged launches {paged}")
    drain_svc = service(model)
    seen = []

    def drain_after(req, result, version):
        seen.append(req.req_id)
        if len(seen) == DRAIN_AFTER:
            drain_svc.drain("smoke")

    drain_svc._feedback = drain_after
    ops.reset_launches()
    drep = drain_svc.serve(reqs, snapshot_dir=d("snap"))
    paged += fused_decode_stride_paged.launches
    tobs.shutdown()
    total["fused_decode_stride_paged"] += paged
    bundles = sorted(n for n in os.listdir(d("obs_serve"))
                     if n.startswith("postmortem"))
    check(drep.drained and bundles == ["postmortem_01_serving_drain_smoke"],
          f"obs serve: drained {drep.drained}, bundles {bundles}")
    drain_bundle = verified_bundle(d(f"obs_serve/{bundles[0]}"))
    serve_rep = obs_report.report_run(d("obs_serve"))
    emit_cost = obs_emit_cost(d("obs_cost"))
    check(serve_rep["serving"] is not None
          and serve_rep["serving"].get("slo") is not None,
          "obs serve: no serving or SLO section")
    line = {
        "phase": "obs", "preset": "msrvtt_cst_consensus",
        "coverage": rep["coverage"], "wall_s": rep["wall_s"],
        "train_rows": host_rows(rep), "span_s": step_s, "mfu": mfu,
        "device_peak_flops": peak, "memory_gauges": mem,
        "card_memory": total_mem, "ring_steps": len(tap.ring),
        "recorder_flushes": tap.readbacks, "postmortem": bundle,
        "profile_kernels": {
            "xe": sorted(k[:60] for k in xe_kernels
                         if ATTENTION_SYMBOL in k),
            "rl": sorted({s for s in STEP_SYMBOLS
                          if any(s in k for k in rl_kernels)})},
        "compile": rep["compile"], "eval_coverage": erep["coverage"],
        "eval_rows": host_rows(erep, 4), "eval_wall_s": erep["wall_s"],
        "overhead": overhead,
        "serve": {"requests_per_s_in_turns": serve_rps,
                  "median_on_over_off": float(np.median(serve_rps["on"])
                                              / np.median(serve_rps["off"])),
                  "funnel": funnel, "strides": srep.strides,
                  "paged_launches": paged, "wall_s": swall,
                  "requests_per_s": N_REQUESTS / swall,
                  "coverage": serve_rep["coverage"],
                  "rows": host_rows(serve_rep),
                  "drained_after": len(seen), "drain_postmortem":
                  drain_bundle},
        "emit_cost": emit_cost,
        "train_and_eval_s": train_s, "phase_s": time.perf_counter() - t0,
        "launches": dict(total), "nvidia_smi": smi}
    return line, total


# ---- phase 8d: data parallel ---------------------------------------------

DP_DEVICE = "cuda:0"
DP_BACKEND_A = "nccl"     # arm (a)'s group
DP_MODEL: dict = {}       # model overrides (a CPU rehearsal shrinks it)
DP_TIMEOUT_S = 600        # a rank of arm (b), start to exit
DP_GROUP_TIMEOUT_S = 120  # a collective that waits this long raises
DP_FROM_START = 2         # pipelined: batches 0 and 1 decode the start weights
DP_REDUCE_REPS = 10
DP_FIT_EPOCHS, DP_FIT_LR = 4, 2e-3   # the start weights' short XE fit
DP_KERNELS = ("fused_additive_attention", "fused_decode_step",
              "fused_decode_stride", "fused_beam_step")
DP_PHASES = ("xe", "cst", "scst")
# float32: the JAX data-parallel tests' compute and tolerances; bfloat16:
# the presets' compute, held to bounds set from the card's readings
DP_DTYPES = ("float32", "bfloat16")
XE_TOL = (1e-3, 1e-5)     # rtol, atol: tests/test_train.py:88-89
RL_TOL = (1e-2, 2e-3)     # tests/test_rl.py:159
DP_TOL = {"xe": XE_TOL, "cst": RL_TOL, "scst": RL_TOL}
BF16_ATOL = 5e-3          # tests/test_comms.py:289-291
DP_RATE = 5e-2            # the RL rate those tolerances were set for
# Bounds from the card's readings (PERF.md, data parallel), each above
# what the correct reduction reads and below what a planted fault reads
# (a zeroed leaf reads 1 in both measures). DP_DISP: per JAX leaf, the
# difference of
# two runs' displacements from the start weights over the reference's
# (``dp_close``; read at most 4.9e-4 in float32, 0.53 in bfloat16: the
# SCST epoch's attention score vector, whose small RL gradient Adam moves
# by its sign). DP_GRAD: the reduced gradient's largest difference, a
# share of its leaf's largest element (``dp_rate_close``; read 3.1e-5 at
# f32, 8.0e-3 with bf16 on the wire, which rounds each addend to 2^-9).
# DP_LOSS: the XE losses, relative (the float32 one is the JAX tests';
# bfloat16 read 4.0e-4, and a planted fault moves them less than that, so
# the params gate is the one that catches it).
DP_DISP = {"float32": 1e-2, "bfloat16": 0.8}
DP_LOSS = {"float32": 1e-5, "bfloat16": 1e-3}
DP_GRAD = {"f32": 1e-4, "bf16": 2.0 ** -6}
DP_FAULTS = ("zero", "offset")
# the leaf whose bfloat16 displacement after the SCST epoch spreads
# nearest a lost leaf's (PERF.md, data parallel): at bfloat16 compute it
# is held by its reduced gradient after one SCST update instead, at
# DP_GRAD's bf16 bound, where a zeroed bucket reads 1
DP_BF16_LEAF = "params/cell/attention/score/kernel"


def dp_config(ckpt_dir: str, preset: str, obs_dir: str, **over):
    """``preset`` at full width with the kernels, B=64, one epoch a phase
    over the recipe corpus's 384 train clips (6 steps), obs on at
    ``obs_dir``; dropout 0 (a rank's dropout stream folds its rank, so one
    rank and two would draw other masks) and float32 compute unless
    ``model__dtype`` says otherwise (the JAX data-parallel tests run so,
    and their tolerances are float32's)."""
    return get_preset(preset).override(**{
        "model__attention_impl": "pallas", "model__decode_impl": "pallas",
        "model__dropout": 0.0, "model__dtype": "float32",
        **{f"model__{k}": v for k, v in DP_MODEL.items()},
        "train__epochs": 1, "train__log_every_steps": 1,
        "train__ckpt_dir": ckpt_dir, "rl__epochs": 1,
        "train__obs": bool(obs_dir), "train__obs_dir": obs_dir, **over})


def dp_sync() -> None:
    if torch.device(DP_DEVICE).type == "cuda":
        torch.cuda.synchronize()


def dp_layout(start: dict) -> tuple[list, list]:
    """The start weights as the port's tensors (on the host) and the JAX
    leaves located in them (``mesh.param_leaves``)."""
    from cst_captioning_tpu_torch.train.mesh import param_leaves

    model = load_flax_params(CaptionModel(dp_config(
        "", "msrvtt_cst_consensus", "").model, device="cpu"), start)
    return [p.detach().clone() for p in model.parameters()], \
        param_leaves(model)


def dp_leaf_views(tensors: list, leaves: list) -> list:
    """Each JAX leaf's elements of a port tensor list, flat, on the host."""
    flat = [t.detach().cpu().reshape(-1) for t in tensors]
    return [flat[lf.param][lf.offset:lf.offset + lf.numel] for lf in leaves]


def _share(num: float, den: float) -> float:
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def dp_close(got: list, want: list, tol, layout: tuple) -> dict:
    """Two runs' parameters from one start -> the largest error, the
    elements outside ``|got - want| <= atol + rtol * |want|`` (``tol``;
    None counts none) and ``disp_rel``: per JAX leaf, the difference of
    the two displacements from the start over the reference's,
    ``||got - want|| / ||want - start||``, the largest and its leaf. A
    leaf whose gradient the reduction lost reads 1 (it never moved); one
    split back at another offset reads about sqrt(2); a summation order
    reads far less, at any rate."""
    start, leaves = layout
    rtol, atol = tol or (math.inf, math.inf)
    worst, bad, n, disp, at = 0.0, 0, 0, 0.0, None
    for lf, g, w, s in zip(leaves, *(dp_leaf_views(x, leaves)
                                     for x in (got, want, start))):
        g, w, s = g.double(), w.double(), s.double()
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        bad += int((d > atol + rtol * w.abs()).sum())
        n += d.numel()
        r = _share(float(d.norm()), float((w - s).norm()))
        if r > disp:
            disp, at = r, lf.path
    return {"max_abs_err": worst, "outside_tol": bad, "elements": n,
            "disp_rel": disp, "disp_leaf": at}


def dp_rate_close(got: dict, want: dict, tol: tuple, leaves: list,
                  bound: float) -> dict:
    """One update at DP_RATE (``dp_rate_update``) against a reference ->
    the loss's relative error; ``grad_rel``, the largest difference of the
    two reduced gradients (Adam's first moment) as a share of the
    reference leaf's largest element; the elements of the params outside
    ``|got - want| <= atol + rtol * |want|`` and how many of those are
    excused: where the reference's gradient lies within ``bound`` of its
    leaf's largest of 0, the reduction's rounding decides its sign and
    Adam's first step moves it by lr one way or the other. A lost or
    misplaced bucket reads ``grad_rel`` 1 or more and moves elements whose
    gradients are far from 0."""
    rtol, atol = tol
    grad_rel, worst, bad, excused = 0.0, 0.0, 0, 0
    views = [dp_leaf_views(x, leaves) for x in (
        got["params"], want["params"], got["grads"], want["grads"])]
    for p, q, g, h in zip(*views):
        scale = float(h.abs().max())
        grad_rel = max(grad_rel, _share(float((g - h).abs().max()), scale))
        d = (p - q).abs()
        worst = max(worst, float(d.max()))
        out = d > atol + rtol * q.abs()
        bad += int(out.sum())
        excused += int((out & (h.abs() <= bound * scale)).sum())
    return {"loss_rel_err": rel_err(got["loss"], want["loss"]),
            "grad_rel": grad_rel, "max_abs_err": worst, "outside_tol": bad,
            "excused": excused}


def dp_rate_ok(c: dict, bound: float, loss_rtol: float) -> bool:
    return c["loss_rel_err"] <= loss_rtol and c["grad_rel"] <= bound \
        and c["outside_tol"] == c["excused"]


def dp_rows_equal(got: list, want: list, rows=slice(None)) -> list:
    """Per batch, the share of token rows (lane, clip) equal between two
    runs' rollouts; ``rows`` picks a rank's clips of ``want``."""
    out = []
    for g, w in zip(got, want):
        w = w[:, rows]
        out.append(float((g == w).all(dim=-1).float().mean())
                   if g.shape == w.shape else 0.0)
    return out


@contextlib.contextmanager
def dp_planted(kind: str, leaf: int | None = None):
    """A fault planted in the gradient all-reduce, alike on every rank:
    the smallest bucket's sum (with ``leaf``, the bucket holding that
    leaf index) zeroed ("zero") or split back one element off ("offset").
    The gates must refuse what it trains."""
    from cst_captioning_tpu_torch.parallel import comms

    wait = comms.Reduction.wait

    def planted(self):
        bucketed = [i for i, p in enumerate(self._pending)
                    if p[2] is not None and (leaf is None or leaf in p[2])]
        if bucketed:
            i = min(bucketed, key=lambda i: self._pending[i][1].numel())
            work, buf, indices = self._pending[i]
            if work is not None:
                work.wait()
            if kind == "zero":
                buf.zero_()
            else:
                buf.copy_(buf.roll(1))
            self._pending[i] = (None, buf, indices)
        return wait(self)

    comms.Reduction.wait = planted
    try:
        yield
    finally:
        comms.Reduction.wait = wait


def dp_reduce_ms(mesh, comm, leaves: list, shapes: list) -> float:
    """CUDA-event ms of one update's gradient all-reduce (a step's
    ``GradReducer``, its plan built once, on gradient-shaped tensors), the
    mean of ``DP_REDUCE_REPS`` after a warm-up."""
    from cst_captioning_tpu_torch.parallel.comms import GradReducer

    reduce = GradReducer(leaves, mesh, comm)
    g = torch.Generator(device=mesh.device).manual_seed(mesh.rank)
    grads = [torch.randn(s, generator=g, device=mesh.device) for s in shapes]
    reduce(grads)
    if mesh.device.type != "cuda":      # a CPU rehearsal: the host clock
        t = time.perf_counter()
        for _ in range(DP_REDUCE_REPS):
            reduce(grads)
        return (time.perf_counter() - t) * 1e3 / DP_REDUCE_REPS
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(DP_REDUCE_REPS):
        reduce(grads)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / DP_REDUCE_REPS


def dp_fit(root: str, data: dict, ds) -> dict:
    """The start weights: the trainer's seeded init after DP_FIT_EPOCHS XE
    epochs at DP_FIT_LR on one device (captions that end and differ, as a
    model past its first epochs gives; random weights leave beam search a
    field of near-ties) -> the flax tree."""
    from cst_captioning_tpu_torch.convert import state_dict_to_flax

    cfg = dp_config(os.path.join(root, "fit"), "msrvtt_cst_consensus", "",
                    train__epochs=DP_FIT_EPOCHS, train__lr=DP_FIT_LR)
    tr = trainer_mod.Trainer(cfg, ds, None, device=DP_DEVICE)
    tr.train_xe()
    tr.close()
    return state_dict_to_flax(tr.model.cfg, tr.model.state_dict())


def dp_schedule(root: str, data: dict, start: dict, use_mesh: bool,
                dtype: str = "float32",
                phases: tuple = ("xe", "cst", "scst", "beam"),
                over: dict | None = None) -> dict:
    """The data-parallel phase's schedule on this process (module
    docstring, 8d) at compute ``dtype``, each phase from the start weights
    (``dp_fit``): an XE epoch with its greedy validation, a CST epoch
    (msrvtt_cst_consensus: K=5, self-consensus, pipelined), an SCST epoch
    (msrvtt_scst's RL: the greedy baseline's fused stride decode), and the
    beam-5 evaluation of the start weights on the val split (64 clips). ->
    the params after each phase, every batch's rollouts (this rank's
    rows), the losses, captions and metrics, the four kernels' launches,
    step times, the ``rl.update.allreduce`` spans and the comm gauges.
    ``over``: more config overrides for every run (the seq_parallel
    phase's impls, dropout and grid; the model_parallel phase's grid,
    which the beam-5 evaluation takes too). ``"split"`` in ``phases`` adds
    a decoupled RL epoch (msrvtt_cst_consensus, the actor/learner split
    of ``rl/async_scst.py``) from the start weights."""
    from cst_captioning_tpu_torch.rl import scst as scst_mod
    from cst_captioning_tpu_torch.train.mesh import make_mesh

    over = over or {}
    mc = dp_config(root, "msrvtt_cst_consensus", "",
                   model__dtype=dtype, **over).model
    ds = {s: CaptionDataset(data["info_json"],
                            {n: data[n] for n, _ in mc.modalities}, s,
                            mc.max_frames,
                            consensus_weights=data["consensus_weights"])
          for s in ("train", "val")}
    out: dict = {}
    orig = scst_mod.SCSTTrainer._score

    def run(name, preset, rl=False, val=None, **extra):
        log = os.path.join(root, f"{name}.jsonl")
        obs_dir = os.path.join(root, f"obs_{name}")
        cfg = dp_config(os.path.join(root, name), preset, obs_dir,
                        model__dtype=dtype, data__cider_df=data["cider_df"],
                        **over, **extra)
        rows = out.setdefault(f"{name}_rollouts", [])

        def recording(self, greedy, samples, *rest, **kw):
            rows.append(samples.cpu() if greedy is None else
                        torch.cat([greedy[None], samples]).cpu())
            return orig(self, greedy, samples, *rest, **kw)

        tr = trainer_mod.Trainer(cfg, ds["train"], val, log_path=log,
                                 device=DP_DEVICE, params=start,
                                 use_mesh=use_mesh)
        scst_mod.SCSTTrainer._score = recording
        t = time.perf_counter()
        try:
            if rl:
                tr.epoch = tr.xe_epochs = 1    # the CST epoch's batch order
                tr.train_rl()
            else:
                tr.train_xe()
            dp_sync()
            out[f"{name}_s"] = time.perf_counter() - t
            if val is not None:
                out["val_captions"] = tr.validator.generate()
        finally:
            scst_mod.SCSTTrainer._score = orig
            tr.close()
            out[f"{name}_comm"] = (tobs.gauge("comm.buckets").value,
                                   tobs.gauge("comm.bytes_on_wire").value)
            tobs.shutdown()
        out[f"{name}_params"] = [p.detach().clone()
                                 for p in tr.model.parameters()]
        proc = "" if tr.rank == 0 else f".proc{tr.rank}"
        logp = log.replace(".jsonl", f"{proc}.jsonl")
        ev = "rl" if rl else "xe"
        out[f"{name}_step_ms"] = _res_events(logp, f"{ev}_epoch")[-1][
            "step_ms_median"]
        out[f"{name}_losses"] = [e["rl_loss" if rl else "loss"]
                                 for e in _res_events(logp, f"{ev}_step")]
        sub = os.path.join(obs_dir, f"proc{tr.rank}") if tr.rank \
            else obs_dir
        spans = [e for e in obs_report.load_events(sub)
                 if e["event"] == "span" and e["name"] == "dcn.collective"]
        out[f"{name}_allreduce_ms"] = [e["dur"] * 1e3 for e in spans
                                       if e.get("op") ==
                                       "rl.update.allreduce"]
        out[f"{name}_collective_ops"] = sorted({e.get("op") for e in spans})
        out["proc_dir"] = os.path.isdir(sub)

    dp_sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    if "xe" in phases:
        run("xe", "msrvtt_cst_consensus", val=ds["val"])
    if "cst" in phases:
        run("cst", "msrvtt_cst_consensus", rl=True)
    if "scst" in phases:
        run("scst", "msrvtt_scst", rl=True)
    if "split" in phases:
        run("split", "msrvtt_cst_consensus", rl=True,
            train__rl_topology="decoupled")
    if "beam" in phases:
        ecfg = dp_config(root, "msrvtt_eval_beam5", "", model__dtype=dtype)
        emodel = CaptionModel(ecfg.model, device=DP_DEVICE)
        load_flax_params(emodel, start)
        mp = over.get("mesh__mp_devices", 1)
        mesh = make_mesh(mp_devices=mp, device=DP_DEVICE) if use_mesh \
            else None
        t = time.perf_counter()
        res = Evaluator(emodel, ds["val"], ecfg.eval, batch_size=TRAIN_B,
                        mesh=mesh).evaluate()
        dp_sync()
        out.update(beam_s=time.perf_counter() - t,
                   beam_captions=res["captions"], beam_metrics=res["metrics"])
    out.update(wall_s=time.perf_counter() - t0, launches=all_launches())
    return out


def dp_compare(got: dict, want: dict, layout: tuple,
               rows=slice(None)) -> dict:
    """One run of the schedule against a reference run of it: the params
    after each phase (``dp_close`` at the JAX tolerances), the losses, the
    rollouts (``rows``: this rank's clips of the reference's), the greedy
    validation and the beam-5 captions and metrics."""
    return {
        "params": {n: dp_close(got[f"{n}_params"], want[f"{n}_params"],
                               DP_TOL[n], layout) for n in DP_PHASES},
        "loss_rel_err": {n: max(rel_err(x, y) for x, y in zip(
            got[f"{n}_losses"], want[f"{n}_losses"]))
            if len(got[f"{n}_losses"]) == len(want[f"{n}_losses"])
            else math.inf for n in DP_PHASES},
        "rollout_rows_equal": {n: dp_rows_equal(
            got[f"{n}_rollouts"], want[f"{n}_rollouts"], rows)
            for n in ("cst", "scst")},
        "val_agreement": dp_caption_agreement(got["val_captions"],
                                              want["val_captions"]),
        "val_clips_equal": set(got["val_captions"]) ==
        set(want["val_captions"]),
        "beam_equal": got["beam_captions"] == want["beam_captions"]
        and got["beam_metrics"] == want["beam_metrics"]}


def dp_gate(arm: str, dtype: str, c: dict) -> None:
    """A schedule's comparison (``dp_compare``) through the gates of its
    compute dtype. Both: every param's leaf within DP_DISP of the
    reference's displacement, the XE losses within DP_LOSS, every rollout
    row decoded from the start weights equal, the validation over the
    same clips, the beam-5 captions and metrics equal. float32 adds the
    JAX tolerances (no element outside) and >= AGREE of the rollout rows
    over the epoch and of the validation captions (later batches decode
    weights that differ by the update's summation order)."""
    f32 = dtype == "float32"
    where = f"data_parallel {arm} {dtype}"
    for n, p in c["params"].items():
        check(p["disp_rel"] <= DP_DISP[dtype]
              and (p["outside_tol"] == 0 or not f32),
              f"{where}: {n} params {p}")
    check(c["loss_rel_err"]["xe"] <= DP_LOSS[dtype],
          f"{where}: XE losses {c['loss_rel_err']}")
    for n, agree in c["rollout_rows_equal"].items():
        check(len(agree) == 6 and min(agree[:DP_FROM_START]) == 1.0
              and (float(np.mean(agree)) >= AGREE or not f32),
              f"{where}: {n} rollout rows equal {agree}")
    check(c["val_clips_equal"]
          and (c["val_agreement"] >= AGREE or not f32),
          f"{where}: validation captions agree {c['val_agreement']}")
    check(c["beam_equal"], f"{where}: beam-5 captions or metrics differ")


def dp_rate_update(data: dict, start: dict, mesh, comm,
                   dtype: str = "float32",
                   preset: str = "msrvtt_cst_consensus") -> dict:
    """One CST update (K=5; msrvtt_scst's K=1 with that ``preset``) at
    DP_RATE and compute ``dtype``, Adam from zero moments, from the
    start weights on the first video-mode batch (this rank's rows with a
    ``mesh``, all 64 without): rollouts decoded from the start weights
    (equal at any world size), seeded advantages -> the loss, the params
    and the reduced gradient as Adam's first moment holds it ((1 - b1)
    times the clipped gradient after one step)."""
    from cst_captioning_tpu_torch.rl import make_parallel_rl_decode
    from cst_captioning_tpu_torch.rl import make_parallel_rl_update
    from cst_captioning_tpu_torch.rl import make_rl_update

    cfg = dp_config("", preset, "", model__dtype=dtype)
    mc = cfg.model
    ds = CaptionDataset(data["info_json"],
                        {n: data[n] for n, _ in mc.modalities}, "train",
                        mc.max_frames)
    rank, world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
    batch = next(Batcher(ds, batch_size=TRAIN_B, max_len=mc.max_len,
                         mode="video", host_shard=(rank, world))
                 .epoch(shuffle=False))
    dev = torch.device(DP_DEVICE)
    feats = {k: torch.from_numpy(v).to(dev) for k, v in batch.feats.items()}
    masks = {k: torch.from_numpy(v).to(dev)
             for k, v in batch.feat_masks.items()}
    K = cfg.rl.num_rollouts
    model = load_flax_params(CaptionModel(mc, device=dev), start)
    _, samples = make_parallel_rl_decode(model, mesh, K, with_greedy=False)(
        model, feats, masks, 11)
    lb = TRAIN_B // world
    adv = np.random.default_rng(5).standard_normal((K, TRAIN_B))
    adv = torch.from_numpy(adv[:, rank * lb:(rank + 1) * lb].astype(
        np.float32)).to(dev)
    state = create_train_state(model, make_optimizer(
        cfg.train, 1, lr_override=DP_RATE), seed=cfg.train.seed)
    upd = make_rl_update(model) if mesh is None else \
        make_parallel_rl_update(model, mesh, comm=comm)
    state, m = upd(state, feats, masks, samples, adv,
                   torch.ones(lb, device=dev))
    return {"loss": float(m["rl_loss"]),
            "params": [p.detach().cpu().clone() for p in state.params],
            "grads": [mu.cpu().clone() for mu in state.opt_state["mu"]]}


def dp_leaf_grad_rel(got: dict, want: dict, leaves: list,
                     path: str) -> float:
    """One leaf's ``grad_rel`` of two updates (``dp_rate_close``): the
    largest difference of its reduced gradients over the reference's
    largest element."""
    i = next(k for k, lf in enumerate(leaves) if lf.path == path)
    g, h = (dp_leaf_views(x["grads"], leaves)[i] for x in (got, want))
    return _share(float((g - h).abs().max()), float(h.abs().max()))


def dp_caption_agreement(got: dict, want: dict) -> float:
    return float(np.mean([got.get(v) == c for v, c in want.items()]))


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


_DP_REF_KEYS = (*(f"{n}_{k}" for n in DP_PHASES for k in ("params",
                                                            "losses")),
                "cst_rollouts", "scst_rollouts", "val_captions",
                "beam_captions", "beam_metrics")


def _dp_times(x: dict) -> dict:
    return {n: {"s": x[f"{n}_s"], "step_ms_median": x[f"{n}_step_ms"],
                "update_allreduce_span_ms": x[f"{n}_allreduce_ms"]}
            for n in DP_PHASES}


def dp_child(argv: list) -> int:
    """One rank of arm (b): gloo on ``cuda:0`` (named explicitly: two
    ranks cannot share a card over NCCL), the schedule at each compute
    dtype, the update at DP_RATE with f32 and bf16 on the wire and with
    each planted fault, the comparisons with arm (a)'s reference; a result
    pickle for the parent."""
    import pickle

    from cst_captioning_tpu_torch.train import multihost
    from cst_captioning_tpu_torch.train.mesh import make_mesh

    global DP_DEVICE, DP_MODEL
    rank, world, init, args_path, out_path = argv
    with open(args_path, "rb") as f:
        a = pickle.load(f)
    if a.get("job") == "elastic":
        return el_child(rank, int(world), a, out_path)
    rank, world = int(rank), int(world)
    if a.get("job") == "rl_split":
        return split_child(rank, world, init, a, out_path)
    if a.get("job") in ("seq_parallel", "mp_decode", "mp_epochs"):
        # six ranks share the host's cores at once: one intra-op thread a
        # rank keeps their CPU pools from competing (seq_parallel and
        # model_parallel 208.1 -> 181.4 s in one call on an H100 host).
        # The two- and three-rank phases keep the default: with one
        # thread data_parallel took 134.5 s, against 103.0-107.2 without
        torch.set_num_threads(1)
        child = sp_child if a["job"] == "seq_parallel" else mp_child
        return child(rank, world, init, a, out_path)
    DP_DEVICE, DP_MODEL = a["device"], a["model"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"file://{init}", world_size=world, rank=rank,
                         backend="gloo", device=DP_DEVICE,
                         timeout_s=DP_GROUP_TIMEOUT_S)
    try:
        root = os.path.join(a["root"], f"rank{rank}")
        ref = torch.load(a["ref"], map_location="cpu")
        layout = dp_layout(a["start"])
        lb = TRAIN_B // world
        rows = slice(rank * lb, (rank + 1) * lb)
        res = {"rank": rank}
        for dtype in DP_DTYPES:
            got = dp_schedule(os.path.join(root, dtype), a["data"],
                              a["start"], True, dtype)
            res[dtype] = {
                "compare": dp_compare(got, ref[dtype], layout, rows),
                "digests": {n: multihost.allgather_pyobj(
                    _digest(got[f"{n}_params"])) for n in DP_PHASES},
                "times": _dp_times(got), "wall_s": got["wall_s"],
                "beam_s": got["beam_s"], "launches": got["launches"],
                "comm": {n: got[f"{n}_comm"] for n in DP_PHASES},
                "collective_ops": got["cst_collective_ops"],
                "proc_dir": got["proc_dir"]}
        # the update at the JAX tests' rate: f32 and bf16 on the wire, and
        # the planted faults, each against arm (a)'s f32 update
        multihost.barrier()
        mesh = make_mesh(device=DP_DEVICE)
        leaves = layout[1]
        f32 = dp_rate_update(a["data"], a["start"], mesh, CommConfig())
        b16 = dp_rate_update(a["data"], a["start"], mesh,
                             CommConfig(dtype="bf16"))
        res["rate_vs_a"] = dp_rate_close(f32, ref["rate"], RL_TOL, leaves,
                                         DP_GRAD["f32"])
        res["bf16"] = dp_rate_close(b16, f32, (0.0, BF16_ATOL), leaves,
                                    DP_GRAD["bf16"])
        res["planted"] = {}
        for kind in DP_FAULTS:
            with dp_planted(kind):
                bad = dp_rate_update(a["data"], a["start"], mesh,
                                     CommConfig())
            res["planted"][kind] = dp_rate_close(bad, ref["rate"], RL_TOL,
                                                 leaves, DP_GRAD["f32"])
        # bfloat16 compute: the SCST update's score vector by its reduced
        # gradient, and the same with that leaf's bucket zeroed
        b16c = dp_rate_update(a["data"], a["start"], mesh, CommConfig(),
                              "bfloat16", "msrvtt_scst")
        res["bf16_leaf"] = dp_leaf_grad_rel(b16c, ref["rate_bf16"], leaves,
                                            DP_BF16_LEAF)
        at = next(k for k, lf in enumerate(leaves)
                  if lf.path == DP_BF16_LEAF)
        with dp_planted("zero", leaf=at):
            bad = dp_rate_update(a["data"], a["start"], mesh, CommConfig(),
                                 "bfloat16", "msrvtt_scst")
        res["planted"]["bf16_leaf_zero"] = dp_leaf_grad_rel(
            bad, ref["rate_bf16"], leaves, DP_BF16_LEAF)
        with dp_planted("zero"):
            bad = dp_schedule(os.path.join(root, "planted"), a["data"],
                              a["start"], True, "bfloat16", phases=("xe",))
        res["planted"]["bf16_xe_zero"] = {
            "disp": dp_close(bad["xe_params"], ref["bfloat16"]["xe_params"],
                             None, layout),
            "loss_rel_err": max(rel_err(x, y) for x, y in zip(
                bad["xe_losses"], ref["bfloat16"]["xe_losses"]))}
        shapes = [p.shape for p in layout[0]]
        res["reduce_ms"] = {w: dp_reduce_ms(mesh, CommConfig(dtype=w),
                                            leaves, shapes)
                            for w in ("f32", "bf16")}
    finally:
        multihost.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    return 0


def data_parallel_phase(root: str, smi: str) -> tuple[dict, dict, dict,
                                                     dict]:
    """Data parallel at full width (module docstring, 8d), its files under
    ``root`` -> (its line, the launches of its runs: arm (a)'s mesh runs
    and both ranks' of arm (b), the corpus's paths, the start weights)."""
    try:
        return _data_parallel(root, smi)
    finally:
        tobs.shutdown()


def spawn_ranks(root: str, args: dict, world: int, label: str,
                timeout: float) -> tuple[list, float]:
    """This script as ``world`` ``--dp-rank`` children on the one card
    (gloo), given ``args`` -> each rank's result pickle and the wall
    seconds; a rank that fails fails the phase with its stderr."""
    return finish_ranks(start_ranks(root, args, world, label, timeout))


def start_ranks(root: str, args: dict, world: int, label: str,
                timeout: float) -> dict:
    """Start :func:`spawn_ranks`'s children and return at once;
    :func:`finish_ranks` waits (several launches may run together)."""
    import pickle

    path = os.path.join(root, f"{label}.args")
    with open(path, "wb") as f:
        pickle.dump(args, f)
    init = os.path.join(root, f"{label}.init")
    outs = [os.path.join(root, f"{label}.rank{r}.out") for r in range(world)]
    errs = [os.path.join(root, f"{label}.rank{r}.err") for r in range(world)]
    h = {"label": label, "outs": outs, "errs": errs, "procs": [],
         "t": time.perf_counter(), "deadline": time.monotonic() + timeout}
    try:
        for r in range(world):
            with open(errs[r], "w") as err:
                h["procs"].append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--dp-rank",
                     str(r), str(world), init, path, outs[r]],
                    stdout=subprocess.DEVNULL, stderr=err))
    except BaseException:
        _stop(h["procs"])
        raise
    return h


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_ranks(h: dict) -> tuple[list, float]:
    """Wait for a :func:`start_ranks` launch -> :func:`spawn_ranks`'s
    result."""
    import pickle

    procs = h["procs"]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, h["deadline"] - time.monotonic()))
    finally:
        _stop(procs)
    wall = time.perf_counter() - h["t"]
    check(all(p.returncode == 0 for p in procs),
          f"{h['label']}: a rank failed:\n" +
          "\n".join(open(e).read()[-4000:] for e in h["errs"]))
    return [pickle.load(open(o, "rb")) for o in h["outs"]], wall


def dp_launch(root: str, data: dict, start: dict, a: dict,
              a_rate: dict, a_rate_bf16: dict) -> tuple[list, float]:
    """Arm (b): this script as two ``--dp-rank`` children on the one card,
    given arm (a)'s reference -> their results and the wall seconds."""
    ref = os.path.join(root, "ref.pt")
    torch.save({**{d: {k: a[d][k] for k in _DP_REF_KEYS} for d in DP_DTYPES},
                "rate": a_rate, "rate_bf16": a_rate_bf16}, ref)
    return spawn_ranks(root, {"root": root, "data": data, "ref": ref,
                              "start": start, "device": DP_DEVICE,
                              "model": DP_MODEL}, 2, "data_parallel (b)",
                       DP_TIMEOUT_S)


def dp_start(root: str) -> tuple[dict, dict, float]:
    """The recipe corpus under ``root`` and the start weights fitted on
    it (``dp_fit``) -> (the corpus's paths, the weights, the fit's s)."""
    data = recipe_corpus(root)
    mc = dp_config(root, "msrvtt_cst_consensus", "").model
    t = time.perf_counter()
    start = dp_fit(root, data, CaptionDataset(
        data["info_json"], {n: data[n] for n, _ in mc.modalities}, "train",
        mc.max_frames, consensus_weights=data["consensus_weights"]))
    return data, start, time.perf_counter() - t


def _data_parallel(root: str, smi: str) -> tuple[dict, dict]:
    from cst_captioning_tpu_torch.parallel.comms import ledger
    from cst_captioning_tpu_torch.train import multihost
    from cst_captioning_tpu_torch.train.mesh import make_mesh

    t_phase = time.perf_counter()
    data, start, fit_s = dp_start(root)
    layout = dp_layout(start)
    leaves = layout[1]
    # arm (a): NCCL at world size 1 beside the same schedule without a mesh
    one = {d: dp_schedule(os.path.join(root, "one", d), data, start, False,
                          d) for d in DP_DTYPES}
    one_rate = dp_rate_update(data, start, None, None)
    multihost.initialize(f"file://{os.path.join(root, 'nccl.init')}",
                         world_size=1, rank=0, backend=DP_BACKEND_A,
                         device=DP_DEVICE, timeout_s=DP_GROUP_TIMEOUT_S)
    try:
        check(multihost.backend() == DP_BACKEND_A,
              f"data_parallel: the group is {multihost.backend()}")
        nccl = (str(torch.cuda.nccl.version()) if DP_BACKEND_A == "nccl"
                else None)
        a = {d: dp_schedule(os.path.join(root, "a", d), data, start, True,
                            d) for d in DP_DTYPES}
        mesh = make_mesh(device=DP_DEVICE)
        a_rate = dp_rate_update(data, start, mesh, CommConfig())
        a_rate_bf16 = dp_rate_update(data, start, mesh, CommConfig(),
                                     "bfloat16", "msrvtt_scst")
        a_reduce_ms = dp_reduce_ms(mesh, CommConfig(), leaves,
                                   [p.shape for p in layout[0]])
    finally:
        multihost.shutdown()
    led = ledger(leaves, CommConfig())
    compare_a = {d: dp_compare(a[d], one[d], layout) for d in DP_DTYPES}
    for d in DP_DTYPES:
        dp_gate("(a)", d, compare_a[d])
        for n in DP_PHASES:
            check(a[d][f"{n}_comm"] == (led["buckets"],
                                        led["bytes_on_wire_per_update"]),
                  f"data_parallel (a): comm gauges {a[d][n + '_comm']} "
                  f"!= {led}")
        for k in DP_KERNELS:
            check(a[d]["launches"][k] > 0,
                  f"data_parallel (a) {d}: {k} never launched")
    rate_a = dp_rate_close(a_rate, one_rate, RL_TOL, leaves, DP_GRAD["f32"])
    check(dp_rate_ok(rate_a, DP_GRAD["f32"], 1e-5),
          f"data_parallel (a): the update at lr {DP_RATE} {rate_a}")

    # arm (b): two ranks on the one card over gloo, against arm (a)
    ranks, b_wall = dp_launch(root, data, start, a, a_rate, a_rate_bf16)
    for r in ranks:
        for d in DP_DTYPES:
            for n in DP_PHASES:
                check(len(set(r[d]["digests"][n])) == 1,
                      f"data_parallel (b) {d}: rank params differ after {n}")
            dp_gate(f"(b) rank {r['rank']}", d, r[d]["compare"])
            for k in DP_KERNELS:
                check(r[d]["launches"][k] > 0,
                      f"data_parallel (b) {d}: rank {r['rank']} never "
                      f"launched {k}")
        check(dp_rate_ok(r["rate_vs_a"], DP_GRAD["f32"], 1e-5),
              f"data_parallel (b): the update at lr {DP_RATE} vs arm (a) "
              f"{r['rate_vs_a']}")
        # (c): bf16 on the wire against f32 (the loss never rides it)
        check(dp_rate_ok(r["bf16"], DP_GRAD["bf16"], 1e-6),
              f"data_parallel (c): bf16 vs f32 {r['bf16']}")
        for kind in DP_FAULTS:
            check(not dp_rate_ok(r["planted"][kind], DP_GRAD["f32"], 1e-5),
                  f"data_parallel (b): the planted '{kind}' fault passed "
                  f"the update's gates {r['planted'][kind]}")
        planted = r["planted"]["bf16_xe_zero"]
        check(planted["disp"]["disp_rel"] > DP_DISP["bfloat16"],
              f"data_parallel (b): the planted fault passed the bfloat16 "
              f"params gate {planted}")
        # (d): bfloat16 compute, the score vector's reduced gradient after
        # one SCST update against arm (a)'s; its zeroed bucket must fail
        check(r["bf16_leaf"] <= DP_GRAD["bf16"],
              f"data_parallel (d): {DP_BF16_LEAF} grad_rel "
              f"{r['bf16_leaf']} > {DP_GRAD['bf16']}")
        check(r["planted"]["bf16_leaf_zero"] > DP_GRAD["bf16"],
              f"data_parallel (d): the planted zeroed bucket of "
              f"{DP_BF16_LEAF} passed its gate "
              f"{r['planted']['bf16_leaf_zero']}")
    check(ranks[1]["float32"]["proc_dir"]
          and {"rl.update.allreduce", "global_weighted_mean", "ckpt.save"}
          <= set(ranks[1]["float32"]["collective_ops"]),
          "data_parallel (b): no proc1/ stream with the dcn.collective "
          f"spans: {ranks[1]['float32']['collective_ops']}")

    launched = dict.fromkeys(all_launches(), 0)
    for src in (*(a[d]["launches"] for d in DP_DTYPES),
                *(r[d]["launches"] for r in ranks for d in DP_DTYPES)):
        for k, v in src.items():
            launched[k] += v
    line = {
        "phase": "data_parallel", "preset": "msrvtt_cst_consensus",
        "global_batch": TRAIN_B, "nccl": nccl, "fit_s": fit_s,
        "buckets": led["buckets"],
        "bytes_on_wire": led["bytes_on_wire_per_update"],
        "bounds": {"disp": DP_DISP, "loss": DP_LOSS, "grad": DP_GRAD,
                   "rate": DP_RATE},
        "a_nccl_world1": {
            **{d: {"wall_s": a[d]["wall_s"], "mesh": _dp_times(a[d]),
                   "no_mesh": _dp_times(one[d]),
                   "no_mesh_wall_s": one[d]["wall_s"],
                   "vs_no_mesh": compare_a[d],
                   "launches": a[d]["launches"]} for d in DP_DTYPES},
            "rate_update_vs_no_mesh": rate_a,
            "reduce_ms": a_reduce_ms},
        "b_gloo_2ranks_one_card": {
            "wall_s": b_wall, "note": "gloo through the host",
            "ranks": [{"rank": r["rank"], "reduce_ms": r["reduce_ms"],
                       "rate_update_vs_a": r["rate_vs_a"],
                       **{d: {k: r[d][k] for k in (
                           "wall_s", "times", "compare", "launches")}
                          for d in DP_DTYPES}} for r in ranks]},
        "c_bf16_wire": [r["bf16"] for r in ranks],
        "d_bf16_score_grad_rel": [r["bf16_leaf"] for r in ranks],
        "planted": [r["planted"] for r in ranks],
        "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    return line, launched, data, start


# ---- phase 8e: the actor/learner split across ranks -----------------------

SPLIT_WORLD = 3           # arm (b): round(3 * 0.5) = 2 actors, 1 learner
SPLIT_FRACTION = 0.5
SPLIT_TIMEOUT_S = 600     # a rank of arm (b), start to exit
SPLIT_D2B1 = dict(rollout_depth=2, staleness_bound=1)
# (name, preset, ring, faults at rl.actor.step: (kind, visit)); the epochs
# of arm (b), each at float32 and at bfloat16
SPLIT_RUNS = (
    ("d2b1", "msrvtt_cst_consensus", SPLIT_D2B1, ()),
    ("d3b1", "msrvtt_cst_consensus",
     dict(rollout_depth=3, staleness_bound=1), ()),
    ("regrow", "msrvtt_cst_consensus", SPLIT_D2B1,
     (("actor_preempt", 2), ("host_rejoin", 4))),
    ("exhaust", "msrvtt_cst_consensus", SPLIT_D2B1,
     (("actor_preempt", 2), ("actor_preempt", 3))),
    ("scst", "msrvtt_scst", SPLIT_D2B1, ()),
)
# planted faults, each in a float32 d2b1 epoch: the gates must refuse them
SPLIT_PLANTED = ("stale_actor", "rows_off_by_one")
# the split's RL rate: the JAX RL tolerances' (DP_RATE), at which one
# update moves the tokens, so that a version off by one shows (at the
# presets' 2e-5 consecutive versions decode the same tokens)
SPLIT_RATE = DP_RATE


def split_inputs(data: dict, preset: str, dtype: str, dev):
    """The phase's model config, its RL reward and the 6 video-mode
    batches of 64 (the recipe corpus's 384 train clips, the data_parallel
    phase's order for its RL epoch), staged on the card."""
    cfg = dp_config("", preset, "", model__dtype=dtype,
                    data__cider_df=data["cider_df"])
    mc = cfg.model
    ds = CaptionDataset(data["info_json"],
                        {n: data[n] for n, _ in mc.modalities}, "train",
                        mc.max_frames,
                        consensus_weights=data["consensus_weights"])
    rl = cfg.rl
    reward = RewardComputer(
        ds.vocab, ds.gts_pool(), df=CorpusDF.load(data["cider_df"]),
        cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads)
    batcher = Batcher(ds, batch_size=TRAIN_B, max_len=mc.max_len,
                      mode="video", seed=cfg.data.shuffle_seed)
    batcher.epoch_index = 1
    batches = [({k: torch.from_numpy(x).to(dev) for k, x in b.feats.items()},
                {k: torch.from_numpy(x).to(dev)
                 for k, x in b.feat_masks.items()},
                list(b.video_ids), [bool(v) for v in b.valid])
               for b in batcher.epoch(shuffle=True)]
    return cfg, reward, batches


def split_epoch(inputs, start: dict, ring: dict, faults, mesh, dev) -> dict:
    """One decoupled epoch from the start weights on ``mesh`` (the ranks
    of arm (b), a world-1 mesh, a mesh of virtual ranks or None) -> the
    rows its learner scored, losses, rewards, the params' digest, the
    ledgers and events, launches by kernel and decode steps, the wall,
    the occupancy and each broadcast's seconds."""
    from cst_captioning_tpu_torch.resilience.chaos import Fault, FaultPlan
    from cst_captioning_tpu_torch.rl import async_scst
    from cst_captioning_tpu_torch.train import multihost

    cfg, reward, batches = inputs
    rl = dataclasses.replace(cfg.rl, actor_fraction=SPLIT_FRACTION, **ring)
    model = load_flax_params(CaptionModel(cfg.model, device=dev), start)
    state = create_train_state(model, make_optimizer(
        cfg.train, 1, lr_override=SPLIT_RATE), seed=cfg.train.seed)
    rec = RecordingReward(reward)
    events = []
    tr = AsyncSCSTTrainer(model, rec, rl, guard=True, batch_size=TRAIN_B,
                          mesh=mesh,
                          on_event=lambda e, **kw: events.append([e, kw]))
    plan = FaultPlan([Fault("rl.actor.step", k, at=at) for k, at in faults])
    bcast, real = [], multihost.broadcast_tensors

    def timed(*a, **kw):
        t = time.perf_counter()
        real(*a, **kw)
        bcast.append(time.perf_counter() - t)

    base = cfg.train.seed + 1
    steps, counting = counted_sample_steps()
    dp_sync()
    ops.reset_launches()
    t = time.perf_counter()
    with counting, plan.activate(), mock.patch.object(
            async_scst.multihost, "broadcast_tensors", timed):
        state, ms = tr.train_epoch(state, batches,
                                   lambda j: rollout_seed(base, 0, 1, j))
    dp_sync()
    wall = time.perf_counter() - t
    return {"calls": rec.calls, "losses": [m["rl_loss"] for m in ms],
            "rewards": [m["reward_mean"] for m in ms],
            "finite": all(m["nonfinite"] == 0.0 and np.isfinite(m["rl_loss"])
                          for m in ms),
            "digest": _digest(state.params), "step": int(state.step),
            "staleness": {str(k): v for k, v in tr.last_staleness.items()},
            "dropped": tr.last_dropped, "events": events,
            "fired": [f["kind"] for f in plan.fired],
            "launches": all_launches(), "decode_steps": steps[0],
            "wall_s": wall, "clips_per_s": len(ms) * TRAIN_B / wall,
            "occupancy": tr.last_occupancy, "broadcast_s": bcast,
            "role": ("actor" if tr._split() and tr._me in
                     tr._initial_plan.actor_ranks else
                     "learner" if tr._split() else "both")}


@contextlib.contextmanager
def split_planted(kind: str):
    """A fault planted in the split, on the ranks it concerns: an actor
    that decodes with the previous parameter version ("stale_actor": the
    broadcast lands, the actor keeps the version before it), or a
    handoff that routes rows one rank off ("rows_off_by_one": the learner
    takes actor i's rows from actor i + 1). The gates must refuse what it
    trains."""
    from cst_captioning_tpu_torch.rl import async_scst

    cls = async_scst.AsyncSCSTTrainer
    if kind == "stale_actor":
        real = cls._refresh_actor
        held = {}

        def patched(self, state):
            before = self._actor_version
            real(self, state)
            if self._split() and self._me in self._plan.actor_ranks \
                    and self._actor_version != before:
                with torch.no_grad():
                    params = [p.data for p in state.model.parameters()]
                    new = [p.clone() for p in params]
                    for p, q in zip(params, held.get("prev", new)):
                        p.copy_(q)
                held["prev"] = new
        name = "_refresh_actor"
    else:
        real = cls._routes

        def patched(self, B):
            A = self._plan.actor_ranks
            return [(A[(A.index(a) + 1) % len(A)] if lr == self._me else a,
                     lr, lo, hi, a0, l0)
                    for a, lr, lo, hi, a0, l0 in real(self, B)]
        name = "_routes"
    with mock.patch.object(cls, name, patched):
        yield


def split_child(rank: int, world: int, init: str, a: dict,
                out_path: str) -> int:
    """One rank of arm (b): gloo on the card, every epoch of SPLIT_RUNS at
    each compute dtype, then the planted faults -> a result pickle (the
    learner's scored rows only on the learner)."""
    import pickle

    from cst_captioning_tpu_torch.train import multihost
    from cst_captioning_tpu_torch.train.mesh import make_mesh

    global DP_DEVICE, DP_MODEL
    DP_DEVICE, DP_MODEL = a["device"], a["model"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(a["device"])
    multihost.initialize(f"file://{init}", world_size=world, rank=rank,
                         backend="gloo", device=a["device"],
                         timeout_s=DP_GROUP_TIMEOUT_S)
    res = {"rank": rank, "runs": {}, "planted": {}}
    try:
        mesh = make_mesh(device=dev)
        inputs = {}
        for dtype in DP_DTYPES:
            for name, preset, ring, faults in SPLIT_RUNS:
                if (preset, dtype) not in inputs:
                    inputs[preset, dtype] = split_inputs(a["data"], preset,
                                                         dtype, dev)
                res["runs"][name, dtype] = split_epoch(
                    inputs[preset, dtype], a["start"], ring, faults, mesh,
                    dev)
        x = inputs["msrvtt_cst_consensus", "float32"]
        for kind in SPLIT_PLANTED:
            with split_planted(kind):
                res["planted"][kind] = split_epoch(x, a["start"], SPLIT_D2B1,
                                                   (), mesh, dev)
        multihost.barrier()
    finally:
        multihost.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    return 0


def split_equal(got: dict, want: dict, learner: bool) -> list:
    """What differs between a rank's epoch and the one-process reference
    on the same schedule, plan and faults (empty: bitwise equal): the
    learner's scored token rows, the losses and rewards, the params'
    digest, the staleness ledger, the drops and the events."""
    bad = []
    if learner and (len(got["calls"]) != len(want["calls"]) or not all(
            np.array_equal(x, y) for x, y in zip(got["calls"],
                                                 want["calls"]))):
        bad.append("tokens")
    for k in ("losses", "rewards", "digest", "step", "staleness", "dropped",
              "events"):
        if got[k] != want[k]:
            bad.append(k)
    return bad


def rl_split_phase(root: str, data: dict, start: dict, smi: str
                   ) -> tuple[dict, dict]:
    """The actor/learner split (module docstring, 8e) on the
    data_parallel phase's corpus and start weights -> (its line, the
    launches of arm (a)'s mesh epoch and of every rank's epochs in arm
    (b))."""
    from cst_captioning_tpu_torch.train import multihost
    from cst_captioning_tpu_torch.train.mesh import DataMesh, make_mesh

    t_phase = time.perf_counter()
    dev = torch.device(DP_DEVICE)
    # the one-process references: every role in this process, on a mesh
    # of SPLIT_WORLD virtual ranks (the split's plan, events and ledgers)
    virtual = DataMesh("data", 0, SPLIT_WORLD, dev)
    inputs, refs = {}, {}
    t = time.perf_counter()
    for dtype in DP_DTYPES:
        for name, preset, ring, faults in SPLIT_RUNS:
            if (preset, dtype) not in inputs:
                inputs[preset, dtype] = split_inputs(data, preset, dtype,
                                                     dev)
            refs[name, dtype] = split_epoch(inputs[preset, dtype], start,
                                            ring, faults, virtual, dev)
    ref_s = time.perf_counter() - t
    x = inputs["msrvtt_cst_consensus", "float32"]
    one = split_epoch(x, start, SPLIT_D2B1, (), None, dev)
    check(not split_equal(one, refs["d2b1", "float32"], True),
          "rl_split: the virtual-rank plan and no mesh differ: "
          f"{split_equal(one, refs['d2b1', 'float32'], True)}")
    for dtype in DP_DTYPES:
        d3 = refs["d3b1", dtype]
        check(d3["staleness"] == {str(k): v for k, v in
                                  D3B1_STALENESS.items()}
              and d3["dropped"] == D3B1_DROPPED,
              f"rl_split: depth 3 bound 1 {dtype} ledger {d3['staleness']}, "
              f"dropped {d3['dropped']}; the JAX trainer's: "
              f"{D3B1_STALENESS}, {D3B1_DROPPED}")
        check([e for e, _ in refs["regrow", dtype]["events"]]
              == ["rl_actor_degraded", "rl_actor_regrown"]
              and [e for e, _ in refs["exhaust", dtype]["events"]]
              == ["rl_actor_degraded", "rl_actor_fallback_sync"],
              f"rl_split: the reference's events {dtype}: "
              f"{refs['regrow', dtype]['events']}, "
              f"{refs['exhaust', dtype]['events']}")
    # arm (a): NCCL at world 1, the shared plan: the one-process epoch
    multihost.initialize(f"file://{os.path.join(root, 'split.init')}",
                         world_size=1, rank=0, backend=DP_BACKEND_A,
                         device=DP_DEVICE, timeout_s=DP_GROUP_TIMEOUT_S)
    try:
        a = split_epoch(x, start, SPLIT_D2B1, (), make_mesh(device=dev), dev)
    finally:
        multihost.shutdown()
    bad = split_equal(a, one, True)
    check(not bad, f"rl_split (a): NCCL at world 1 differs from one "
          f"process in {bad}")
    # arm (b): SPLIT_WORLD gloo ranks on the one card
    ranks, b_wall = spawn_ranks(
        root, {"job": "rl_split", "data": data, "start": start,
               "device": DP_DEVICE, "model": DP_MODEL}, SPLIT_WORLD,
        "rl_split (b)",
        SPLIT_TIMEOUT_S)
    launched = dict(a["launches"])
    report = {}
    T = x[0].model.max_len
    faults_of = {n: f for n, _, _, f in SPLIT_RUNS}
    for (name, dtype), want in refs.items():
        per_rank = []
        for r in ranks:
            got = r["runs"][name, dtype]
            learner = got["role"] == "learner"
            bad = split_equal(got, want, learner)
            check(not bad and got["finite"]
                  and got["fired"] == [k for k, _ in faults_of[name]],
                  f"rl_split (b) {name} {dtype} rank {r['rank']} "
                  f"({got['role']}) differs from one process in {bad}, "
                  f"fired {got['fired']}")
            n = got["launches"]
            updates = len(want["losses"])
            if learner:
                check(n["fused_additive_attention"] == T * updates,
                      f"rl_split (b) {name} {dtype}: the learner launched "
                      f"{n['fused_additive_attention']} attention kernels "
                      f"for {updates} updates")
            else:
                check(n["fused_additive_attention"] == 0,
                      f"rl_split (b) {name} {dtype}: an actor launched "
                      f"the attention kernel: {n}")
            decode = ("fused_decode_stride" if name == "scst"
                      else "fused_decode_step")
            other = ("fused_decode_step" if name == "scst"
                     else "fused_decode_stride")
            if name != "scst":
                check(n[decode] == got["decode_steps"],
                      f"rl_split (b) {name} {dtype}: {n[decode]} decode-"
                      f"step launches for {got['decode_steps']} steps")
            check(n[other] == n["fused_decode_stride_paged"]
                  == n["fused_beam_step"] == 0,
                  f"rl_split (b) {name} {dtype}: other kernels {n}")
            for k, v in n.items():
                launched[k] += v
            per_rank.append({"rank": r["rank"], "role": got["role"],
                             "wall_s": got["wall_s"], "launches": n,
                             "broadcast_ms": [s * 1e3 for s in
                                              got["broadcast_s"]]})
        # every actor decoded and the learner recounted only after drops,
        # orphans or the sync fallback
        roles = {p["role"]: p for p in per_rank}
        check(any(p["launches"][decode] > 0 for p in per_rank
                  if p["role"] == "actor"),
              f"rl_split (b) {name} {dtype}: no actor decoded")
        if name in ("d2b1", "scst"):
            check(roles["learner"]["launches"][decode] == 0,
                  f"rl_split (b) {name} {dtype}: the learner decoded")
        got0 = ranks[0]["runs"][name, dtype]
        check(all(r["runs"][name, dtype]["occupancy"] == got0["occupancy"]
                  for r in ranks), f"rl_split (b) {name}: occupancy differs")
        report[f"{name}_{dtype}"] = {
            "wall_s": max(p["wall_s"] for p in per_rank),
            "clips_per_s": min(r["runs"][name, dtype]["clips_per_s"]
                               for r in ranks),
            "one_process_clips_per_s": want["clips_per_s"],
            "occupancy": got0["occupancy"],
            "staleness": got0["staleness"], "dropped": got0["dropped"],
            "events": got0["events"], "ranks": per_rank}
    planted = {}
    for kind in SPLIT_PLANTED:
        bad = sorted({b for r in ranks for b in split_equal(
            r["planted"][kind], refs["d2b1", "float32"],
            r["planted"][kind]["role"] == "learner")})
        check(bad, f"rl_split (b): the planted '{kind}' fault passed the "
              "gates")
        planted[kind] = bad
    bms = [m for p in report["d2b1_float32"]["ranks"]
           for m in p["broadcast_ms"]]
    return {"phase": "rl_split", "preset": "msrvtt_cst_consensus",
            "scst_preset": "msrvtt_scst", "global_batch": TRAIN_B,
            "world": SPLIT_WORLD, "actor_fraction": SPLIT_FRACTION,
            "plan": {"actors": list(range(2)), "learners": [2]},
            "batches": len(x[2]), "reference_s": ref_s,
            "a_nccl_world1": {"wall_s": a["wall_s"],
                              "clips_per_s": a["clips_per_s"],
                              "one_process_clips_per_s": one["clips_per_s"]},
            "b_gloo_ranks_one_card": {
                "wall_s": b_wall, "note": "gloo through the host, one "
                "card time-sliced: semantics, not speed", **report},
            "broadcast_ms_per_update": bms, "planted": planted,
            "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi}, \
        launched



# ---- phase 8f: elastic training over real ranks ------------------------------

EL_XE_EPOCHS, EL_RL_EPOCHS = 2, 2
EL_KILL_XE_STEP = 3       # (a): host 1 dies after logging this XE step
EL_KILL_RL_STEPS = 2      # (b): host 0 dies this many RL steps after both
                          # the regrow and the RL phase's start
EL_KILL_SCST_STEP = 2     # (e): host 1 dies after this SCST step
EL_OFFSET_S = 0.037       # a kill lands this long after the step's event
EL_BOUNDARY_S = 0.3       # a degraded boundary's wait: a restarted host
                          # arrives while the survivors still train
EL_TIMEOUT_S = 420        # a launch, start to exit
EL_STANDBY_WAIT_S = 300   # a restarted host's wait for its tombstone
EL_PLANTED = ("own_state", "stale_rejoin")


class ElasticRefEnd(Exception):
    """A reference run reached the end of the stretch it checks."""


def el_config(root: str, preset: str, hosts: int, **over):
    """``preset`` as the data_parallel phase runs it (full width, the
    kernels, dropout 0, float32, B=64) with checkpoints under ``root``,
    the monitor on over two hosts (``hosts`` 0: the real ranks; 2:
    simulated in one process), ``elastic="degraded"``, the health phase's
    watchdog periods, every step save kept."""
    return dp_config(root, preset, "", **{
        "train__epochs": EL_XE_EPOCHS, "rl__epochs": EL_RL_EPOCHS,
        "train__health": True, "train__health_sim_hosts": hosts,
        "train__health_dir": os.path.join(root, "health"),
        "train__health_interval_s": HEALTH_INTERVAL_S,
        "train__peer_timeout_s": HEALTH_TIMEOUT_S,
        "train__health_misses": HEALTH_MISSES,
        "train__elastic": "degraded", "train__keep_ckpts": 64,
        "train__eval_every_epochs": 100, **over})


def el_fingerprint(state) -> str:
    """A bitwise fingerprint of a TrainState, taken on the card: per
    tensor (params, Adam moments) the integer sum of its bit patterns and
    their position-weighted sum, hashed with the step."""
    import hashlib

    tensors = list(state.params)
    for k in sorted(state.opt_state):
        if isinstance(state.opt_state[k], list):
            tensors.extend(state.opt_state[k])
    sums = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(
            torch.int32 if t.element_size() == 4 else torch.int16
        ).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        sums.append(torch.stack([bits.sum(), (bits * w).sum()]))
    h = hashlib.sha256(torch.stack(sums).cpu().numpy().tobytes())
    h.update(str(int(state.step)).encode())
    return h.hexdigest()


def el_tap(path: str, stop_at: str | None = None):
    """Append one line a step to ``path``, flushed (a killed process
    keeps what it wrote): ``"<phase>:<step>"``, the state's fingerprint,
    the world, the step's ms and the kernel launches so far. ``stop_at``
    raises :class:`ElasticRefEnd` after that step. -> the undo."""
    from cst_captioning_tpu_torch.rl import scst as scst_mod

    f = open(path, "a", buffering=1)
    saved = (trainer_mod.make_parallel_xe_step, trainer_mod.make_xe_step,
             scst_mod.SCSTTrainer._apply)

    def record(key, state, world, t0):
        dp_sync()
        f.write(json.dumps({"key": key, "fp": el_fingerprint(state),
                            "world": world,
                            "ms": (time.perf_counter() - t0) * 1e3,
                            "ts": time.time(),
                            "launches": all_launches()}) + "\n")
        if key == stop_at:
            raise ElasticRefEnd(key)

    def wrap(factory, parallel):
        def make(*args, **kw):
            step = factory(*args, **kw)
            world = args[1].world if parallel else 1

            def tapped(state, *rest):
                t0 = time.perf_counter()
                state, m = step(state, *rest)
                record(f"xe:{int(state.step)}", state, world, t0)
                return state, m
            return tapped
        return make

    def apply(self, state, *rest):
        t0 = time.perf_counter()
        state, m = saved[2](self, state, *rest)
        record(f"rl:{int(state.step)}", state,
               1 if self.mesh is None else self.mesh.world, t0)
        return state, m

    trainer_mod.make_parallel_xe_step = wrap(saved[0], True)
    trainer_mod.make_xe_step = wrap(saved[1], False)
    scst_mod.SCSTTrainer._apply = apply

    def undo():
        (trainer_mod.make_parallel_xe_step, trainer_mod.make_xe_step,
         scst_mod.SCSTTrainer._apply) = saved
        f.close()
    return undo


def el_harness(root: str, planted: str = ""):
    """Wrap the Trainer's continuations for this phase -> the undo. Each
    drain save a continuation restores is hard-linked to
    ``<root>/drains/h<host>_<i>_<kind>`` (a later save of the same step
    number replaces the original) for its reference; a degraded boundary
    waits ``EL_BOUNDARY_S``. ``planted``: ``own_state`` keeps the
    survivor's own state and bookkeeping instead of the drain save;
    ``stale_rejoin`` takes, at a regrow, the drain save's position with
    the previous drain save's parameters and moments: the stale state a
    rejoiner would bring."""
    orig = trainer_mod.Trainer._restore_drain
    poll = trainer_mod.Trainer._poll_rejoin
    seen: list = []

    def keep(self, kind):
        name = self._last_step_ckpt
        if self.rank == 0:
            shutil.copytree(
                os.path.join(self.cfg.train.ckpt_dir, name),
                os.path.join(root, "drains",
                             f"h{self.host_id}_{len(seen)}_{kind}", name),
                copy_function=os.link)
        seen.append(name)

    def restore(self, what):
        kind = what.split()[0]
        if planted == "own_state" and kind == "degraded":
            keep(self, kind)
            return self.state, self._ckpt_infos()
        out = orig(self, what)      # names the agreed drain save
        keep(self, kind)
        if planted == "stale_rejoin" and kind == "regrow":
            # the drain's position, the previous drain's state
            self._last_step_ckpt = seen[-2]
            stale, _ = orig(self, what)
            self._last_step_ckpt = seen[-1]
            return stale, out[1]
        return out

    def slow_poll(self):
        if self.health is not None and self.health.lost_hosts:
            time.sleep(EL_BOUNDARY_S)
        poll(self)

    trainer_mod.Trainer._restore_drain = restore
    trainer_mod.Trainer._poll_rejoin = slow_poll

    def undo():
        trainer_mod.Trainer._restore_drain = orig
        trainer_mod.Trainer._poll_rejoin = poll
    return undo


def el_drains(root: str) -> dict:
    """The drain saves the harness kept, by host, in order: each with its
    directory, name, kind and ``"<phase>:<step>"`` key."""
    out: dict = {}
    d = os.path.join(root, "drains")
    for entry in sorted(os.listdir(d), key=lambda n: int(n.split("_")[1])):
        host, _, kind = entry.split("_")
        (name,) = os.listdir(os.path.join(d, entry))
        infos = json.load(open(os.path.join(d, entry, name, "infos.json")))
        out.setdefault(int(host[1:]), []).append({
            "dir": os.path.join(d, entry), "name": name, "kind": kind,
            "key": f"{infos['phase']}:{infos['global_step']}"})
    return out


def el_dataset(data: dict, mc) -> CaptionDataset:
    return CaptionDataset(data["info_json"],
                          {n: data[n] for n, _ in mc.modalities}, "train",
                          mc.max_frames,
                          consensus_weights=data["consensus_weights"])


def el_child(who: str, world: int, a: dict, out_path: str) -> int:
    """One process of an elastic launch: rank ``who`` of the launch's gloo
    group, or ``standby<i>``, host ``a["standbys"][i]["host"]`` restarted:
    it waits for its tombstone and rejoins through the Trainer
    (``flaky``: it exits after its announce, before the rendezvous). A
    reference rank (``a["ref"]``) resumes ``a["over"]``'s drain save with
    no monitor. Every step's fingerprint streams to
    ``<root>/steps_<label><who>.jsonl``; a result pickle at the end (a
    killed host writes none)."""
    import pickle

    from cst_captioning_tpu_torch.resilience import health
    from cst_captioning_tpu_torch.train import multihost

    global DP_DEVICE, DP_MODEL
    DP_DEVICE, DP_MODEL = a["device"], a["model"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = a["root"]
    cfg = el_config(a.get("ckpt_dir", root), a["preset"], 0,
                    **a.get("over", {}))
    ds = el_dataset(a["data"], cfg.model)
    el_harness(root)
    el_tap(os.path.join(root, f"steps_{a['label']}{who}.jsonl"),
           a.get("stop_at"))
    if who.startswith("standby"):
        spec = a["standbys"][int(who[len("standby"):])]
        host = spec["host"]
        tomb = os.path.join(cfg.train.health_dir, f"host{host}.dead")
        deadline = time.monotonic() + EL_STANDBY_WAIT_S
        while not os.path.exists(tomb):
            if time.monotonic() > deadline:
                return 0
            time.sleep(0.01)
        multihost.set_identity(host, world, "gloo",
                               timeout_s=DP_GROUP_TIMEOUT_S)
        if spec.get("flaky"):
            def gone(*args, **kw):
                os._exit(0)
            health.rendezvous = gone
        log = os.path.join(root, f"log_{who}.jsonl")
    else:
        host = int(who)
        multihost.initialize(f"file://{a['init']}", world_size=world,
                             rank=host, backend="gloo", device=DP_DEVICE,
                             timeout_s=DP_GROUP_TIMEOUT_S)
        log = os.path.join(root, f"log{a['label']}.jsonl")
    ops.reset_launches()
    tr = trainer_mod.Trainer(cfg, ds, None, log_path=log, device=DP_DEVICE,
                             params=a["start"], use_mesh=True)
    if tr.health is not None and not who.startswith("standby"):
        # every monitor has seen its peer beat before anyone dies
        deadline = time.monotonic() + 60.0
        while any(tr.health._seen_seq.get(p) is None
                  for p in tr.health.peers):
            check(time.monotonic() < deadline, "elastic: a peer never beat")
            time.sleep(0.02)
        multihost.barrier()
    try:
        tr.train_xe()
        tr.train_rl()
    except ElasticRefEnd:
        pass
    finally:
        tr.close()
        multihost.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump({"host": host, "launches": all_launches(),
                     "world": tr.world, "rl_epochs": tr.rl_epochs,
                     "generation": (tr.health.generation
                                    if tr.health is not None else None),
                     "survivors": (tr.health.survivors()
                                   if tr.health is not None else None)}, f)
    return 0


def el_spawn(root: str, a: dict, world: int, standbys: int,
             label: str) -> list:
    """Start this script's ``--dp-rank`` children for ``a`` (``world``
    ranks and ``standbys`` restarted hosts) -> [(who, Popen, out, err)]."""
    import pickle

    path = os.path.join(root, f"{label}.args")
    a = {**a, "root": root, "label": label, "job": "elastic",
         "init": os.path.join(root, f"{label}.init"), "device": DP_DEVICE,
         "model": DP_MODEL}
    with open(path, "wb") as f:
        pickle.dump(a, f)
    procs = []
    for who in [str(r) for r in range(world)] + [
            f"standby{i}" for i in range(standbys)]:
        out = os.path.join(root, f"{label}.{who}.out")
        err = os.path.join(root, f"{label}.{who}.err")
        with open(err, "w") as e:
            procs.append((who, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank",
                 who, str(world), a["init"], path, out],
                stdout=subprocess.DEVNULL, stderr=e), out, err))
    return procs


def el_lines(path: str) -> list:
    """The JSON lines written so far (a torn last line skipped)."""
    out = []
    if os.path.exists(path):
        for line in open(path):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def el_wait(pred, procs, what: str):
    """Poll ``pred()`` every 10 ms until it returns a value; a child that
    failed, or the launch's timeout, fails the phase."""
    deadline = time.monotonic() + EL_TIMEOUT_S
    while True:
        got = pred()
        if got:
            return got
        for who, p, _, err in procs:
            if p.poll() not in (None, 0, -9):
                check(False, f"elastic: {who} exited {p.returncode} "
                      f"waiting for {what}:\n" + open(err).read()[-4000:])
        check(time.monotonic() < deadline,
              f"elastic: timed out waiting for {what}")
        time.sleep(0.01)


def el_finish(procs, killed=()) -> dict:
    """Wait for a launch's children -> the results of those that ran to
    their end; one that failed fails the phase."""
    import pickle

    deadline = time.monotonic() + EL_TIMEOUT_S
    out = {}
    try:
        for who, p, res, err in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if who in killed:
                continue
            check(p.returncode == 0, f"elastic: {who} exited "
                  f"{p.returncode}:\n" + open(err).read()[-4000:])
            if os.path.exists(res):
                out[who] = pickle.load(open(res, "rb"))
    finally:
        for _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def el_reference(root: str, data: dict, start: dict, preset: str,
                 drain: dict, world: int, stop_at: str | None, label: str,
                 over: dict | None = None):
    """A fresh run at ``world`` with no monitor, resumed from the drain
    save ``drain``, to ``stop_at`` (or the end). One rank runs in this
    process -> (None, its steps' path); two run as ``--dp-rank`` children
    -> (their Popen list, to finish later; rank 0's steps' path)."""
    over = {**(over or {}), "train__health": False,
            "train__resume": drain["dir"], "mesh__num_devices": world}
    ck = os.path.join(root, f"ref_{label}")
    if world > 1:
        a = {"preset": preset, "data": data, "start": start, "over": over,
             "ckpt_dir": ck, "stop_at": stop_at, "standbys": []}
        return (el_spawn(root, a, world, 0, f"ref_{label}"),
                os.path.join(root, f"steps_ref_{label}0.jsonl"))
    path = os.path.join(root, f"steps_ref_{label}.jsonl")
    cfg = el_config(ck, preset, 0, **over)
    undo = el_tap(path, stop_at)
    try:
        tr = trainer_mod.Trainer(cfg, el_dataset(data, cfg.model), None,
                                 device=DP_DEVICE, params=start,
                                 use_mesh=True)
        try:
            tr.train_xe()
            tr.train_rl()
        except ElasticRefEnd:
            pass
        finally:
            tr.close()
    finally:
        undo()
    return None, path


def el_key(k: str) -> tuple:
    ph, st = k.split(":")
    return {"xe": 0, "rl": 1}[ph], int(st)


def el_stretch(lines: list, world: int, after: str,
               until: str | None = None) -> dict:
    """The step lines taken at ``world`` after the drain ``after`` and up
    to ``until`` (inclusive), by key."""
    lo = el_key(after)
    hi = el_key(until) if until else (9, 0)
    return {x["key"]: x for x in lines
            if lo < el_key(x["key"]) <= hi and x["world"] == world}


def el_differ(got: dict, ref_path: str) -> list:
    """Keys of ``got`` whose fingerprint differs from the reference's (or
    that it never reached)."""
    ref = {x["key"]: x["fp"] for x in el_lines(ref_path)}
    return sorted((k for k, x in got.items() if ref.get(k) != x["fp"]),
                  key=el_key)


def el_first(stretch: dict) -> dict:
    return stretch[min(stretch, key=el_key)]


def el_one(events: list, kind: str, label: str) -> dict:
    got = [e for e in events if e["event"] == kind]
    check(len(got) == 1, f"elastic {label}: {kind} events {got}")
    return got[0]


def el_planted(root: str, data: dict, start: dict, kind: str) -> dict:
    """A planted fault through the continuation in one process, two
    simulated hosts, one XE epoch: ``own_state`` loses host 1 after step
    2; ``stale_rejoin`` loses it and takes it back at the next boundary.
    -> whether the stretch after the planted restore differs from a fresh
    resume of its true drain save (it must)."""
    from cst_captioning_tpu_torch.resilience import Fault, FaultPlan

    P = os.path.join(root, f"planted_{kind}")
    cfg = el_config(P, "msrvtt_cst_consensus", 2, train__epochs=1,
                    mesh__num_devices=1)
    faults = [Fault("xe.step", "partial_preempt", at=1, host=1)]
    if kind == "stale_rejoin":
        faults.append(Fault("health.rejoin", "host_rejoin", at=0, host=1))
    path = os.path.join(P, "steps.jsonl")
    os.makedirs(P, exist_ok=True)
    undo_h, undo_t = el_harness(P, planted=kind), el_tap(path)
    try:
        tr = trainer_mod.Trainer(cfg, el_dataset(data, cfg.model), None,
                                 device=DP_DEVICE, params=start,
                                 use_mesh=True)
        try:
            with FaultPlan(faults).activate():
                tr.train_xe()
        finally:
            tr.close()
    finally:
        undo_t()
        undo_h()
    drain = el_drains(P)[0][-1]
    _, ref = el_reference(P, data, start, "msrvtt_cst_consensus", drain, 1,
                          None, kind, {"train__epochs": 1})
    stretch = el_stretch(el_lines(path), 1, drain["key"])
    bad = el_differ(stretch, ref)
    return {"drain": drain["key"], "steps": len(stretch), "differ": bad}


def elastic_phase(root: str, data: dict, start: dict, smi: str
                  ) -> tuple[dict, dict]:
    """Elastic training over real ranks (module docstring, 8f) on the
    data_parallel phase's corpus and start weights -> (its line, the
    launches of its runs)."""
    try:
        return _elastic(os.path.join(root, "elastic"), data, start, smi)
    finally:
        tobs.shutdown()


def _elastic(root: str, data: dict, start: dict, smi: str
             ) -> tuple[dict, dict]:
    t_phase = time.perf_counter()
    preset = "msrvtt_cst_consensus"
    lo, hi = detection_bound_s()
    window = HEALTH_TIMEOUT_S * HEALTH_MISSES + HEALTH_INTERVAL_S
    total = dict.fromkeys(all_launches(), 0)

    # ---- (a)-(d): one launch: hosts 0 and 1, host 1 restarted (it
    #      rejoins), host 0 restarted flaky
    L = os.path.join(root, "L1")
    os.makedirs(L)
    procs = el_spawn(L, {"preset": preset, "data": data, "start": start,
                         "standbys": [{"host": 1},
                                      {"host": 0, "flaky": True}]},
                     2, 2, "L1")
    log0, log1 = (os.path.join(L, f"logL1{p}.jsonl") for p in ("", ".proc1"))
    log_r = os.path.join(L, "log_standby0.proc1.jsonl")

    def steps(path, kind):
        return [e["step"] for e in el_lines(path) if e["event"] == kind]

    t0 = time.perf_counter()
    el_wait(lambda: max(steps(log1, "xe_step"), default=0)
            >= EL_KILL_XE_STEP, procs, f"host 1's XE step {EL_KILL_XE_STEP}")
    time.sleep(EL_OFFSET_S)
    procs[1][1].kill()
    t_kill_a = time.time()
    regrow = el_wait(lambda: next((e for e in el_lines(log0)
                                   if e["event"] == "mesh_regrow"), None),
                     procs, "the regrow")
    base = max([e["step"] for e in el_lines(log0) if e["event"] == "rl_step"
                and e["ts"] < regrow["ts"]], default=0)
    el_wait(lambda: max(steps(log0, "rl_step"), default=0)
            >= base + EL_KILL_RL_STEPS, procs, "host 0's RL steps")
    time.sleep(EL_OFFSET_S)
    procs[0][1].kill()
    t_kill_b = time.time()
    res = el_finish(procs, {"0", "1"})
    l1_wall = time.perf_counter() - t0
    check("standby0" in res, "elastic: the rejoined host 1 left no result")
    h1 = res["standby0"]
    ev0, evr = el_lines(log0), el_lines(log_r)
    st0 = el_lines(os.path.join(L, "steps_L10.jsonl"))
    st1 = el_lines(os.path.join(L, "steps_L11.jsonl"))
    str_ = el_lines(os.path.join(L, "steps_L1standby0.jsonl"))

    # (a) host 0 finds the loss and goes on at world 1
    lost_a = el_one(ev0, "peer_lost", "(a)")
    deg_a = el_one(ev0, "degraded_mesh", "(a)")
    check(deg_a["lost"] == [1] and deg_a["survivors"] == [0]
          and deg_a["devices"] == 1, f"elastic (a): degraded_mesh {deg_a}")
    xe_clock = sorted(set(steps(log0, "xe_step")))
    check(xe_clock == list(range(1, len(xe_clock) + 1)),
          f"elastic (a): host 0's XE clock {xe_clock}")
    # (c) host 1 restarted rejoins: generation 2, hosts [0, 1]
    rg = el_one(ev0, "mesh_regrow", "(c)")
    check(rg["hosts"] == [0, 1] and rg["generation"] == 2
          and rg["rejoiner"] == 1, f"elastic (c): mesh_regrow {rg}")
    joined = el_one(evr, "rejoined", "(c)")
    check(joined["generation"] == 2 and joined["rank"] == 1,
          f"elastic (c): rejoined {joined}")
    # (b) host 1 finds host 0's loss, writes the drain save and goes on as
    #     rank 0 of generation 3, with no update past the loss
    deg_b = el_one(evr, "degraded_mesh", "(b)")
    drain_b = el_one(evr, "peer_loss_drain", "(b)")
    save_b = [e for e in evr if e["event"] == "ckpt_step"
              and e["step"] == drain_b["step"]][-1]
    check(deg_b["lost"] == [0] and deg_b["survivors"] == [1]
          and "bytes" in save_b and not save_b["seam"]
          and drain_b["batch_index"] == drain_b["step"],
          f"elastic (b): {deg_b}, {drain_b}, {save_b}")
    # (d) the restarted host 0 announces and leaves: refused
    ref_d = el_one(evr, "regrow_refused", "(d)")
    check(ref_d["rejoiner"] == 0 and h1["generation"] == 3
          and h1["survivors"] == [1] and h1["rl_epochs"] == EL_RL_EPOCHS,
          f"elastic (d): {ref_d}, {h1}")
    rl_clock = sorted(set(steps(log0, "rl_step") + steps(log_r, "rl_step")))
    check(rl_clock == list(range(1, len(rl_clock) + 1)),
          f"elastic: the RL clock {rl_clock}")

    # each stretch against a fresh resume from its drain save: (a) world
    # 1 to the regrow, (c) world 2 (both hosts) to host 0's death, (b)
    # and (d) world 1 from host 1's drain to the end, through the refusal
    drains = el_drains(L)
    check([d["kind"] for d in drains[0]] == ["degraded", "regrow"]
          and [d["kind"] for d in drains[1]] == ["degraded", "regrow"],
          f"elastic: drains {drains}")
    dA, dC = drains[0]
    dB = drains[1][0]
    t = time.perf_counter()
    pair, ref_c = el_reference(L, data, start, preset, dC, 2, dB["key"], "C")
    _, ref_a = el_reference(L, data, start, preset, dA, 1, dC["key"], "A")
    _, ref_b = el_reference(L, data, start, preset, dB, 1, None, "B")
    el_finish(pair)
    ref_s = time.perf_counter() - t
    stretches = {
        "a_world1": (el_stretch(st0, 1, dA["key"], dC["key"]), ref_a),
        "c_world2_host0": (el_stretch(st0, 2, dC["key"]), ref_c),
        "c_world2_host1": (el_stretch(str_, 2, dC["key"]),
                           ref_c.replace("C0.jsonl", "C1.jsonl")),
        "bd_world1": (el_stretch(str_, 1, dB["key"]), ref_b)}
    for k, (got, ref) in stretches.items():
        bad = el_differ(got, ref)
        check(got and not bad, f"elastic {k}: {len(got)} steps, {bad} "
              "differ from the fresh resume of their drain save")
    times = [e for e in ev0 + evr if e["event"] == "elastic_times"]
    first_a = next(e for e in ev0 if e["event"] == "xe_step"
                   and e["ts"] > deg_a["ts"])
    first_c = next(e for e in ev0 if e["event"] in ("xe_step", "rl_step")
                   and e["ts"] > rg["ts"])
    first_b = next(e for e in evr if e["event"] == "rl_step"
                   and e["ts"] > deg_b["ts"])
    drain_c = el_one(ev0, "regrow_drain", "(c)")
    lost_b = el_one(evr, "peer_lost", "(b)")
    launches = {"host0": st0[-1]["launches"], "host1": st1[-1]["launches"],
                "host1_rejoined": h1["launches"]}
    for who, src in launches.items():
        for k in ("fused_additive_attention", "fused_decode_step"):
            if who != "host1":      # the first host 1 died in XE
                check(src[k] > 0, f"elastic: {who} never launched {k}")
        for k, v in src.items():
            total[k] += v
    check(lost_a["ts"] - t_kill_a <= window,
          f"elastic (a): detection {lost_a['ts'] - t_kill_a:.3f} s past "
          f"the window {window} s")
    line = {"phase": "elastic", "preset": preset,
            "scst_preset": "msrvtt_scst", "global_batch": TRAIN_B,
            "hosts": 2, "backend": "gloo, two ranks on the one card",
            "detection_bound_s": [lo, hi], "collective_window_s": window,
            "a_c_b_d": {
                "wall_s": l1_wall, "reference_s": ref_s,
                "detection_s": {"a": lost_a["ts"] - t_kill_a,
                                "b": lost_b["ts"] - t_kill_b},
                "detected_by": {"a": lost_a["reason"],
                                "b": lost_b["reason"]},
                "collective_raised": {
                    "a": any(e["event"] == "collective_peer_loss"
                             for e in ev0),
                    "b": any(e["event"] == "collective_peer_loss"
                             for e in evr)},
                "elastic_times": [{k: e[k] for k in (
                    "kind", "generation", "rendezvous_ms", "regroup_ms",
                    "restore_ms", "world")} for e in times],
                "rejoin": {k: joined[k] for k in (
                    "rendezvous_ms", "regroup_ms", "restore_ms")},
                "outage_s": {"shrink_a": first_a["ts"] - t_kill_a,
                             "regrow_c": first_c["ts"] - drain_c["ts"],
                             "shrink_b": first_b["ts"] - t_kill_b},
                "first_step_ms": {
                    k: el_first(got)["ms"] for k, (got, _) in
                    stretches.items()},
                "stretch_steps": {k: len(got) for k, (got, _) in
                                  stretches.items()},
                "drains": {"a": dA["key"], "c": dC["key"], "b": dB["key"]},
                "regrow_refused_d": ref_d["detail"],
                "launches": launches}}

    # ---- (e) SCST (kernel 3 decodes): host 1 dies mid-epoch, host 0
    #      goes on alone
    L2 = os.path.join(root, "L2")
    os.makedirs(L2)
    over_e = {"train__epochs": 0, "rl__epochs": 1}
    procs = el_spawn(L2, {"preset": "msrvtt_scst", "data": data,
                          "start": start, "standbys": [], "over": over_e},
                     2, 0, "L2")
    t0 = time.perf_counter()
    el_wait(lambda: max(steps(os.path.join(L2, "logL2.proc1.jsonl"),
                              "rl_step"), default=0) >= EL_KILL_SCST_STEP,
            procs, "host 1's SCST steps")
    time.sleep(EL_OFFSET_S)
    procs[1][1].kill()
    t_kill_e = time.time()
    res2 = el_finish(procs, {"1"})
    l2_wall = time.perf_counter() - t0
    ev_e = el_lines(os.path.join(L2, "logL2.jsonl"))
    deg_e = el_one(ev_e, "degraded_mesh", "(e)")
    check(deg_e["lost"] == [1] and deg_e["devices"] == 1,
          f"elastic (e): {deg_e}")
    (dE,) = el_drains(L2)[0]
    _, ref_e = el_reference(L2, data, start, "msrvtt_scst", dE, 1, None,
                            "E", over_e)
    st_e = el_lines(os.path.join(L2, "steps_L20.jsonl"))
    got_e = el_stretch(st_e, 1, dE["key"])
    bad_e = el_differ(got_e, ref_e)
    check(got_e and not bad_e,
          f"elastic (e): {len(got_e)} steps, {bad_e} differ from the fresh "
          "resume of the drain save")
    launches_e = {"host0": res2["0"]["launches"],
                  "host1": el_lines(os.path.join(
                      L2, "steps_L21.jsonl"))[-1]["launches"]}
    for who, src in launches_e.items():
        check(src["fused_decode_stride"] > 0,
              f"elastic (e): {who} never launched the stride kernel")
        for k, v in src.items():
            total[k] += v
    lost_e = el_one(ev_e, "peer_lost", "(e)")
    first_e = next(e for e in ev_e if e["event"] == "rl_step"
                   and e["ts"] > deg_e["ts"])
    line["e_scst"] = {
        "wall_s": l2_wall, "drain": dE["key"],
        "detection_s": lost_e["ts"] - t_kill_e,
        "outage_s": first_e["ts"] - t_kill_e,
        "first_step_ms": el_first(got_e)["ms"],
        "elastic_times": [{k: e[k] for k in (
            "kind", "generation", "rendezvous_ms", "regroup_ms",
            "restore_ms", "world")} for e in ev_e
            if e["event"] == "elastic_times"],
        "stretch_steps": len(got_e), "launches": launches_e}

    # ---- planted faults, in one process with two simulated hosts
    planted = {kind: el_planted(root, data, start, kind)
               for kind in EL_PLANTED}
    for kind, p in planted.items():
        check(p["steps"] and p["differ"], f"elastic: the planted '{kind}' "
              f"fault passed the stretch gate {p}")
    line.update(planted=planted, wall_s=time.perf_counter() - t_phase,
                nvidia_smi=smi)
    return line, total

# ---- phase 8g: sequence parallelism over a ('data', 'seq') grid -----------

SP_SEQ = 2                # a row's ranks
SP_TIMEOUT_S = 900        # a launch, start to exit
SP_LONG = (16, 448)       # the long-context point: clips, frames a modality
SP_SEED = 11              # the rollouts' noise seed
SP_RATE = DP_RATE         # one Adam step that moves the params past noise
# the grid runs the plain composites: a kernel's softmax is one device's
# (the JAX package refuses the kernels with seq_devices > 1)
SP_OVER = {"model__attention_impl": "xla", "model__decode_impl": "xla"}
# the epochs keep the preset's dropout: a rank draws its data
# coordinate's masks, the 2-rank data-parallel run's
SP_EPOCH_OVER = {**SP_OVER, "model__dropout": 0.5}
SP_PHASES = ("xe", "cst")
# float32: the CPU tests' tolerances (tests/test_seq_parallel.py:89 for
# the logits, the steps' loss 1e-5 relative and params rtol 1e-4 / atol
# 1e-5; tests/test_trainer_integration.py's seq-devices test for the
# epochs' XE params and losses, the JAX RL tolerance after CST). A step
# at lr 5e-2 is held by its reduced gradient (Adam's first moment) within
# DP_GRAD's f32 share of its leaf's largest element, and by its params
# at SP_STEP_TOL wherever Adam's first step cannot turn the leaf's
# gradient error into more (``adam_step_gap``): an element whose
# gradient lies near Adam's eps moves by up to lr with the summation
# order alone (the card read 8,629 elements of a step outside SP_STEP_TOL
# with the gradients within 3.3e-5; PERF.md, sequence parallel).
SP_FWD_TOL = (2e-5, 1e-5)
SP_STEP_TOL = (1e-4, 1e-5)
SP_LOSS_RTOL = 1e-5
SP_EPOCH_TOL = {"xe": (2e-2, 2e-3), "cst": RL_TOL}
SP_EPOCH_LOSS = 1e-4
# bfloat16: bounds from the card's readings (``chip_smoke.py --phases
# seq_parallel``; PERF.md, sequence parallel), each above what the correct
# grids read and, where a planted fault exists, below what it reads. fwd:
# the logits' largest error over their largest value (read 5.4e-3); grad:
# the reduced gradient's largest difference over its leaf's largest
# element (read 0.110-0.193: the grid's softmax rounds its unnormalised
# weights to bfloat16 where the one-rank softmax rounds normalised ones;
# planted fault (a) reads 0.508-0.509; the attention score vector,
# DP_BF16_LEAF, reads 0.129-0.130 after the chunks-1 update, and 1 with
# its row sum zeroed), loss its relative error (4.4e-4); rows: the share
# of token rows (greedy and K=5 sampled) equal to the one-rank decode's
# (0.994); beam: of beam-5 captions (0.8125: beam search follows
# near-ties); disp: the epochs' ``dp_close`` displacement against the
# 2-rank data-parallel run (XE 0.434; CST 0.810 at the score vector, the
# noise-led leaf that its gradient holds instead; a lost leaf reads 1),
# epoch_loss the XE losses (2.2e-4), epoch_rows the rollout rows of each
# batch (0.9875).
SP_BF16 = {"fwd": 2.0 ** -6, "grad": 0.35, "loss": 1e-3, "rows": AGREE,
           "beam": 0.75, "disp": {"xe": 0.8, "cst": 0.95},
           "epoch_loss": 1e-3, "epoch_rows": AGREE}
# Adam's first step (``train/schedule.py``): lr * g / (|g| + eps), g the
# first moment over its bias correction 1 - 0.9 (float32)
ADAM_EPS = 1e-8
ADAM_C1 = float(1 - np.float32(0.9))


def sp_cfg(dtype: str):
    """msrvtt_cst_consensus at full width and compute ``dtype``, the plain
    composites (``dp_config``'s B=64 and recipe corpus)."""
    return dp_config("", "msrvtt_cst_consensus", "", model__dtype=dtype,
                     **SP_OVER)


def sp_model_of(mc, mesh, start):
    """``mc`` from the start weights on DP_DEVICE: the plain model
    (``mesh`` None) or an ``sp_model`` over the grid's row."""
    from cst_captioning_tpu_torch.parallel.seq_parallel import sp_model

    dev = torch.device(DP_DEVICE)
    model = CaptionModel(mc, device=dev) if mesh is None else \
        sp_model(mc, mesh, device=dev)
    return load_flax_params(model, start)


@contextlib.contextmanager
def sp_planted():
    """Planted fault (a): ``seq_enter``'s backward as the identity, so the
    replicated path takes exact plus this rank's partial gradient."""
    from cst_captioning_tpu_torch.parallel import seq_parallel as sp

    backward = sp._SeqEnter.backward
    sp._SeqEnter.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        sp._SeqEnter.backward = backward


@contextlib.contextmanager
def sp_zeroed_row_sum(index: int):
    """A fault planted in the row's gradient reduction: the row sum of
    parameter ``index`` (``model.parameters()`` order) zeroed on every
    rank (``row_reduce_grads``)."""
    from cst_captioning_tpu_torch.parallel import seq_parallel as sp

    reduce = sp.row_reduce_grads

    def planted(grads, local, row):
        out = reduce(grads, local, row)
        out[index] = torch.zeros_like(out[index])
        return out

    sp.row_reduce_grads = planted
    try:
        yield
    finally:
        sp.row_reduce_grads = reduce


def adam_step_gap(h: torch.Tensor, delta: float, lr: float) -> torch.Tensor:
    """The most that Adam's first step can set apart two elements whose
    gradients are ``h`` and within ``delta`` of it: the step lr * g /
    (|g| + eps) rises with g, so the larger of its moves at h + delta and
    h - delta (up to 2 lr where delta reaches past 0)."""
    def step(g):
        return lr * g / (g.abs() + ADAM_EPS)

    u = step(h)
    return torch.maximum(step(h + delta) - u, u - step(h - delta))


def sp_unexplained(got: dict, want: dict, leaves: list, tol: tuple,
                   lr: float) -> int:
    """The elements of two steps' params (from one start, Adam's first
    step at ``lr``) outside ``tol`` by more than ``adam_step_gap`` of the
    reference's gradient and its leaf's largest gradient error: the
    differences that the two reduced gradients (their first moments over
    ADAM_C1) do not explain."""
    rtol, atol = tol
    n = 0
    for p, q, g, h in zip(*(dp_leaf_views(x, leaves) for x in (
            got["params"], want["params"], got["grads"], want["grads"]))):
        p, q = p.double(), q.double()
        g, h = g.double() / ADAM_C1, h.double() / ADAM_C1
        gap = adam_step_gap(h, float((g - h).abs().max()), lr)
        n += int(((p - q).abs() > gap + atol + rtol * q.abs()).sum())
    return n


def sp_steps(data: dict, start: dict, dtype: str, mesh, ref=None,
             long: bool = False) -> dict:
    """The phase's steps at compute ``dtype`` on one rank of the grid
    ``mesh`` (None: the one-rank reference on the card), each on this
    rank's rows (its data coordinate's) and frames: the forward of the
    first caption-mode batch of 64 train clips, one XE step at SP_RATE
    (Adam from zero moments), the same with planted fault (a) (grid only),
    the fused greedy + K=5 rollout decode of the first video-mode batch,
    the SCST update at SP_RATE with chunks 1 and 5 on the reference's
    rollouts (``ref``; its own on the reference) and seeded advantages,
    the chunks-1 update with the score vector's row sum zeroed (grid
    only), beam-5 over the 64 val clips, and with ``long`` the greedy decode of
    SP_LONG clips. Each is timed (synchronised host clock) and its
    collectives counted (``seq_parallel.COUNTS``)."""
    from cst_captioning_tpu_torch.config import EvalConfig
    from cst_captioning_tpu_torch.decoding import greedy_decode
    from cst_captioning_tpu_torch.parallel import seq_parallel as sp
    from cst_captioning_tpu_torch.rl import make_rl_decode, make_rl_update
    from cst_captioning_tpu_torch.train.mesh import (
        batch_sharding,
        param_leaves,
    )

    cfg = sp_cfg(dtype)
    mc = cfg.model
    dev = torch.device(DP_DEVICE)
    shard = batch_sharding(mesh) if mesh is not None else (0, 1)
    lb = TRAIN_B // shard[1]
    rows = slice(shard[0] * lb, (shard[0] + 1) * lb)
    names = {n: data[n] for n, _ in mc.modalities}

    def up(d):
        if mesh is not None:
            d = sp.shard_frames(mesh, d)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in d.items()}

    ds = CaptionDataset(data["info_json"], names, "train", mc.max_frames)
    cap = next(Batcher(ds, batch_size=TRAIN_B, max_len=mc.max_len,
                       mode="caption", host_shard=shard).epoch(False))
    vid = next(Batcher(ds, batch_size=TRAIN_B, max_len=mc.max_len,
                       mode="video", host_shard=shard).epoch(False))
    feats, masks, vf, vm = (up(cap.feats), up(cap.feat_masks),
                            up(vid.feats), up(vid.feat_masks))
    labels = torch.from_numpy(cap.labels.astype(np.int64)).to(dev)
    lmask = torch.from_numpy(cap.mask).to(dev)
    ones = torch.ones(lb, device=dev)
    out: dict = {"ms": {}, "counts": {}}

    def run(name, fn):
        sp.reset_counts()
        dp_sync()
        t = time.perf_counter()
        r = fn()
        dp_sync()
        out["ms"][name] = (time.perf_counter() - t) * 1e3
        out["counts"][name] = dict(sp.COUNTS)
        return r

    def fresh():
        model = sp_model_of(mc, mesh, start)
        return model, create_train_state(model, make_optimizer(
            cfg.train, 1, lr_override=SP_RATE), seed=cfg.train.seed)

    def result(state, m, key):
        return {"loss": float(m[key]),
                "params": [p.detach().cpu().clone() for p in state.params],
                "grads": [mu.cpu().clone() for mu in state.opt_state["mu"]]}

    # warm-up: a step's first call on a process pays the card's and the
    # allocator's first-use costs
    model, state = fresh()
    (make_xe_step(model) if mesh is None else sp.make_sp_xe_step(
        model, mesh))(state, feats, masks, labels, lmask, ones)
    model = sp_model_of(mc, mesh, start)
    with torch.no_grad():
        out["logits"] = run("forward", lambda: model(
            feats, masks, labels)).float().cpu()
    for name in ("xe", "xe_planted") if mesh is not None else ("xe",):
        model, state = fresh()
        step = make_xe_step(model) if mesh is None else \
            sp.make_sp_xe_step(model, mesh)
        with sp_planted() if name == "xe_planted" else \
                contextlib.nullcontext():
            state, m = run(name, lambda: step(state, feats, masks, labels,
                                              lmask, ones))
        out[name] = result(state, m, "loss")
    model = sp_model_of(mc, mesh, start)
    K = cfg.rl.num_rollouts
    dec = make_rl_decode(model, K) if mesh is None else \
        sp.make_sp_decode(model, mesh, K)
    g, s = run("decode", lambda: dec(model, vf, vm, SP_SEED))
    out["tokens"] = torch.cat([g[None], s]).cpu()
    out["decode_steps"] = decode_depth(out["tokens"], mc.max_len,
                                       mc.decode_stride)
    samples = (ref["tokens"][1:, rows] if ref is not None
               else out["tokens"][1:]).to(dev).long()
    adv = np.random.default_rng(5).standard_normal((K, TRAIN_B))
    adv = torch.from_numpy(adv[:, rows].astype(np.float32)).to(dev)
    score = next(lf.param for lf in param_leaves(model)
                 if lf.path == DP_BF16_LEAF)
    updates = [("update_c1", 1), (f"update_c{K}", K)]
    if mesh is not None:
        updates.append(("update_zero", 1))
    for name, chunks in updates:
        model, state = fresh()
        upd = make_rl_update(model, chunks=chunks) if mesh is None else \
            sp.make_sp_rl_update(model, mesh, chunks=chunks)
        with sp_zeroed_row_sum(score) if name == "update_zero" else \
                contextlib.nullcontext():
            state, m = run(name, lambda: upd(state, vf, vm, samples, adv,
                                             ones))
        out[name] = result(state, m, "rl_loss")
    model = sp_model_of(mc, mesh, start)
    val = CaptionDataset(data["info_json"], names, "val", mc.max_frames)
    ev = Evaluator(model, val, EvalConfig(beam_size=BEAM_W,
                                          max_len=mc.max_len,
                                          metrics=("CIDEr-D",)),
                   batch_size=TRAIN_B, mesh=mesh)
    out["beam"] = run("beam", ev.evaluate)["captions"]
    if long:
        n, F = SP_LONG
        rng = np.random.default_rng(23)
        lf = {k: rng.standard_normal((n, F, dim)).astype(np.float32)
              for k, dim in mc.modalities}
        # ragged: some clips' second half is all padding
        lm = {k: (np.arange(F)[None] < rng.integers(F // 4, F + 1,
                                                    size=(n, 1))
                  ).astype(np.float32) for k, _ in mc.modalities}
        out["long"] = run("long", lambda: greedy_decode(
            model, up(lf), up(lm), max_len=mc.max_len)[0]).cpu()
    return out


def sp_rows_equal(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of token rows (the last axis) equal."""
    return float((got == want).all(dim=-1).float().mean())


def sp_compare(got: dict, ref: dict, rows, leaves: list) -> dict:
    """One grid rank's steps against the one-rank reference: the logits
    (the elements outside the float32 tolerance, the largest error over
    the largest value), each update by ``dp_rate_close`` and
    ``sp_unexplained`` (the planted one too; the bounds of its dtype are
    the caller's gates), the score vector's reduced gradient after the
    chunks-1 update and after the same with its row sum zeroed, the token
    rows, beam captions and long-context rows equal."""
    rtol, atol = SP_FWD_TOL
    want = ref["logits"][rows]
    diff = (got["logits"] - want).abs()
    out = {"fwd": {"outside_tol": int((diff > atol + rtol * want.abs()).sum()),
                   "rel": float(diff.max() / want.abs().max())}}
    for k in ("xe", "xe_planted", "update_c1", "update_c5"):
        w = ref[k.replace("_planted", "")]
        out[k] = dp_rate_close(got[k], w, SP_STEP_TOL, leaves,
                               DP_GRAD["f32"])
        out[k]["unexplained"] = sp_unexplained(got[k], w, leaves,
                                               SP_STEP_TOL, SP_RATE)
    out["score_grad_rel"] = {k: dp_leaf_grad_rel(
        got[k], ref["update_c1"], leaves, DP_BF16_LEAF)
        for k in ("update_c1", "update_zero")}
    w = ref["tokens"][:, rows]
    out["greedy_rows_equal"] = sp_rows_equal(got["tokens"][:1], w[:1])
    out["sampled_rows_equal"] = sp_rows_equal(got["tokens"][1:], w[1:])
    out["beam_agreement"] = dp_caption_agreement(got["beam"], ref["beam"])
    out["beam_clips_equal"] = set(got["beam"]) == set(ref["beam"])
    if "long" in got:
        out["long_rows_equal"] = sp_rows_equal(got["long"], ref["long"])
    return out


def sp_update_ok(c: dict, dtype: str) -> bool:
    """An update's comparison (``sp_compare``) through its dtype's gates:
    at float32 the loss within SP_LOSS_RTOL, the reduced gradient (Adam's
    first moment, what the grid's collectives produce) within DP_GRAD's
    f32 share, and no element of the params outside SP_STEP_TOL that the
    gradients do not explain; at bfloat16 the loss and the gradient
    within SP_BF16."""
    if dtype == "float32":
        return c["loss_rel_err"] <= SP_LOSS_RTOL \
            and c["grad_rel"] <= DP_GRAD["f32"] and c["unexplained"] == 0
    return c["loss_rel_err"] <= SP_BF16["loss"] \
        and c["grad_rel"] <= SP_BF16["grad"]


def sp_gate_steps(where: str, dtype: str, c: dict) -> None:
    """A rank's step comparison through its dtype's gates."""
    f32 = dtype == "float32"
    check(c["fwd"]["outside_tol"] == 0 if f32
          else c["fwd"]["rel"] <= SP_BF16["fwd"],
          f"{where}: forward logits {c['fwd']}")
    for k in ("xe", "update_c1", "update_c5"):
        check(sp_update_ok(c[k], dtype), f"{where}: {k} {c[k]}")
    check(not sp_update_ok(c["xe_planted"], dtype),
          f"{where}: planted fault (a) passed the XE gates "
          f"{c['xe_planted']}")
    bound = DP_GRAD["f32"] if f32 else SP_BF16["grad"]
    score = c["score_grad_rel"]
    check(score["update_c1"] <= bound and score["update_zero"] > bound,
          f"{where}: {DP_BF16_LEAF} grad_rel {score} against {bound} (the "
          "zeroed row sum must read above it)")
    rows = 1.0 if f32 else SP_BF16["rows"]
    check(c["greedy_rows_equal"] >= rows and c["sampled_rows_equal"] >= rows,
          f"{where}: token rows equal {c['greedy_rows_equal']}, "
          f"{c['sampled_rows_equal']} < {rows}")
    check(c["beam_clips_equal"] and c["beam_agreement"]
          >= (1.0 if f32 else SP_BF16["beam"]),
          f"{where}: beam-5 captions agree {c['beam_agreement']}")
    if "long_rows_equal" in c:
        check(c["long_rows_equal"] == 1.0,
              f"{where}: long-context rows equal {c['long_rows_equal']}")


_SP_EPOCH_KEYS = (*(f"{n}_{k}" for n in SP_PHASES
                    for k in ("params", "losses", "rollouts")),
                  "val_captions")


def sp_epoch_compare(got: dict, want: dict, layout: tuple) -> dict:
    """A grid rank's XE and CST epochs against its data coordinate's rank
    of the 2-rank data-parallel run (same rows, same dropout masks): the
    params (``dp_close`` at SP_EPOCH_TOL), the XE losses, the rollout
    rows a batch, the validation captions."""
    return {
        "params": {n: dp_close(got[f"{n}_params"], want[f"{n}_params"],
                               SP_EPOCH_TOL[n], layout) for n in SP_PHASES},
        "loss_rel_err": max((rel_err(x, y) for x, y in zip(
            got["xe_losses"], want["xe_losses"])), default=math.inf)
        if len(got["xe_losses"]) == len(want["xe_losses"]) else math.inf,
        "rollout_rows_equal": dp_rows_equal(got["cst_rollouts"],
                                            want["cst_rollouts"]),
        "val_agreement": dp_caption_agreement(got["val_captions"],
                                              want["val_captions"]),
        "val_clips_equal": set(got["val_captions"]) ==
        set(want["val_captions"])}


def sp_gate_epoch(where: str, dtype: str, c: dict) -> None:
    f32 = dtype == "float32"
    for n, p in c["params"].items():
        check(p["outside_tol"] == 0 if f32
              else p["disp_rel"] <= SP_BF16["disp"][n],
              f"{where}: {n} params {p}")
    check(c["loss_rel_err"] <= (SP_EPOCH_LOSS if f32
                                else SP_BF16["epoch_loss"]),
          f"{where}: XE losses {c['loss_rel_err']}")
    agree = c["rollout_rows_equal"]
    check(len(agree) == 6 and (
        min(agree[:DP_FROM_START]) == 1.0 and float(np.mean(agree)) >= AGREE
        if f32 else min(agree) >= SP_BF16["epoch_rows"]),
          f"{where}: CST rollout rows equal {agree}")
    check(c["val_clips_equal"] and (c["val_agreement"] >= AGREE or not f32),
          f"{where}: validation captions agree {c['val_agreement']}")


def sp_child(rank: int, world: int, init: str, a: dict,
             out_path: str) -> int:
    """One rank of a seq_parallel launch: gloo on the card, the grid
    (``SP_SEQ`` ranks a row), the steps at each compute dtype against the
    parent's one-rank reference; then the epochs: on two ranks the
    data-parallel run (its results saved for the grid), on four the
    (2 x 2) grid's against it -> a result pickle."""
    import pickle

    from cst_captioning_tpu_torch.train import multihost
    from cst_captioning_tpu_torch.train.mesh import make_mesh

    global DP_DEVICE, DP_MODEL
    DP_DEVICE, DP_MODEL = a["device"], a["model"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"file://{init}", world_size=world, rank=rank,
                         backend="gloo", device=DP_DEVICE,
                         timeout_s=DP_GROUP_TIMEOUT_S)
    res: dict = {"rank": rank}
    try:
        ops.reset_launches()
        mesh = make_mesh(seq_devices=SP_SEQ, device=DP_DEVICE)
        d, nd = mesh.data.rank, mesh.data.world
        res["cell"] = (d, mesh.seq.rank)
        ref = torch.load(a["ref"], map_location="cpu")
        layout = dp_layout(a["start"])
        lb = TRAIN_B // nd
        for dtype in DP_DTYPES:
            got = sp_steps(a["data"], a["start"], dtype, mesh, ref[dtype],
                           long=dtype == "float32" and nd == 1)
            res[dtype] = {
                "compare": sp_compare(got, ref[dtype],
                                      slice(d * lb, (d + 1) * lb),
                                      layout[1]),
                "ms": got["ms"], "counts": got["counts"],
                "decode_steps": got["decode_steps"],
                "tokens": multihost.allgather_pyobj(_digest(
                    [got["tokens"]])),
                "xe_params": multihost.allgather_pyobj(_digest(
                    got["xe"]["params"]))}
        del ref
        root = os.path.join(a["root"], f"w{world}_rank{rank}")
        for dtype in DP_DTYPES:
            if world == SP_SEQ:
                # the 2-rank data-parallel run, the (2 x 2) grid's reference
                got = dp_schedule(os.path.join(root, dtype), a["data"],
                                  a["start"], True, dtype, SP_PHASES,
                                  SP_EPOCH_OVER)
                path = a["dp_ref"].format(rank=rank, dtype=dtype)
                # whole or not at all: the grid's ranks, launched beside
                # this run, wait for the file
                torch.save({k: got[k] for k in _SP_EPOCH_KEYS},
                           path + ".part")
                os.replace(path + ".part", path)
                ep = {}
            else:
                got = dp_schedule(os.path.join(root, dtype), a["data"],
                                  a["start"], True, dtype, SP_PHASES,
                                  {**SP_EPOCH_OVER,
                                   "mesh__seq_devices": SP_SEQ})
                path = a["dp_ref"].format(rank=d, dtype=dtype)
                deadline = time.monotonic() + SP_TIMEOUT_S
                while not os.path.exists(path):
                    check(time.monotonic() < deadline,
                          f"seq_parallel: no data-parallel reference {path}")
                    time.sleep(0.5)
                want = torch.load(path, map_location="cpu")
                ep = {"compare": sp_epoch_compare(got, want, layout),
                      "digests": {n: multihost.allgather_pyobj(
                          _digest(got[f"{n}_params"])) for n in SP_PHASES}}
            res[dtype]["epoch"] = {
                **ep, "wall_s": got["wall_s"],
                "times": {n: {"s": got[f"{n}_s"],
                              "step_ms_median": got[f"{n}_step_ms"]}
                          for n in SP_PHASES}}
        res["launches"] = all_launches()
    finally:
        multihost.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    return 0


def seq_parallel_phase(root: str, data: dict, start: dict, smi: str
                       ) -> tuple[dict, dict]:
    """Sequence parallelism (module docstring, 8g) on the data_parallel
    phase's corpus and start weights -> (its line, the launches of its
    runs: none, by design)."""
    try:
        return _seq_parallel(root, data, start, smi)
    finally:
        tobs.shutdown()


def sp_per_step(r: dict, dtype: str) -> dict:
    """A rank's collectives (this module's counters; the column's
    gradient all-reduce of the data axis is the data-parallel one) and
    bytes: per decode step, per XE step, per SCST update."""
    x = r[dtype]
    c, steps = x["counts"], max(x["decode_steps"], 1)

    def calls(op):
        return sum(v for k, v in c[op].items() if not k.endswith("_bytes"))

    def nbytes(op):
        return sum(v for k, v in c[op].items() if k.endswith("_bytes"))

    return {"decode_allreduces_per_step": calls("decode") / steps,
            "decode_bytes_per_step": nbytes("decode") / steps,
            "decode_steps": x["decode_steps"],
            **{f"{k}_allreduces": calls(k) for k in (
                "forward", "xe", "update_c1", "update_c5")},
            **{f"{k}_bytes": nbytes(k) for k in (
                "xe", "update_c1", "update_c5")},
            "by_op": c}


def _seq_parallel(root: str, data: dict, start: dict, smi: str
                  ) -> tuple[dict, dict]:
    t_phase = time.perf_counter()
    ops.reset_launches()
    t = time.perf_counter()
    ref = {d: sp_steps(data, start, d, None, long=d == "float32")
           for d in DP_DTYPES}
    ref_s = time.perf_counter() - t
    one_ms = {d: ref[d]["ms"] for d in DP_DTYPES}
    path = os.path.join(root, "sp_ref.pt")
    torch.save(ref, path)
    del ref
    a = {"job": "seq_parallel", "root": os.path.join(root, "sp"),
         "data": data, "start": start, "device": DP_DEVICE,
         "model": DP_MODEL, "ref": path,
         "dp_ref": os.path.join(root, "sp_dp_rank{rank}_{dtype}.pt")}
    # both grids at once (the (2 x 2) ranks wait for the (1 x 2) run's
    # data-parallel reference before their epochs' comparison): the
    # card is time-sliced between six ranks
    hs = {name: start_ranks(root, a, world, f"seq_parallel ({name})",
                            SP_TIMEOUT_S)
          for world, name in ((SP_SEQ, "1x2"), (2 * SP_SEQ, "2x2"))}
    runs = {name: dict(zip(("ranks", "wall_s"), finish_ranks(h)))
            for name, h in hs.items()}
    for name, run in runs.items():
        for r in run["ranks"]:
            where = f"seq_parallel {name} rank {r['rank']} {r['cell']}"
            check(not any(r["launches"].values()),
                  f"{where}: kernels launched on the grid {r['launches']}")
            for dtype in DP_DTYPES:
                x = r[dtype]
                sp_gate_steps(f"{where} {dtype}", dtype, x["compare"])
                check(len(set(x["xe_params"])) == 1,
                      f"{where} {dtype}: the ranks' params differ")
                S = SP_SEQ
                row = x["tokens"][r["cell"][0] * S:(r["cell"][0] + 1) * S]
                check(len(set(row)) == 1,
                      f"{where} {dtype}: a row's tokens differ")
                if "compare" in x["epoch"]:
                    sp_gate_epoch(f"{where} {dtype} epochs", dtype,
                                  x["epoch"]["compare"])
                    for n, dg in x["epoch"]["digests"].items():
                        check(len(set(dg)) == 1,
                              f"{where} {dtype}: params differ after {n}")
    check(not any(all_launches().values()),
          f"seq_parallel: the one-rank reference launched kernels "
          f"{all_launches()}")
    # the phase's launches: the reference's (counted from 0 at its start)
    # and every rank's
    launched = all_launches()
    for run in runs.values():
        for r in run["ranks"]:
            for k, v in r["launches"].items():
                launched[k] += v
    line = {
        "phase": "seq_parallel", "preset": "msrvtt_cst_consensus",
        "global_batch": TRAIN_B, "seq_devices": SP_SEQ,
        "frames_a_rank": sp_cfg("float32").model.max_frames // SP_SEQ,
        "long_context": {"clips": SP_LONG[0], "frames": SP_LONG[1],
                         "frames_a_rank": SP_LONG[1] // SP_SEQ},
        "bounds": {"float32": {"fwd": SP_FWD_TOL, "step": SP_STEP_TOL,
                               "loss": SP_LOSS_RTOL,
                               "epoch": SP_EPOCH_TOL,
                               "epoch_loss": SP_EPOCH_LOSS},
                   "bfloat16": SP_BF16, "rate": SP_RATE},
        "one_rank": {"ms": one_ms, "s": ref_s},
        "note": "gloo ranks time-sliced on one card: semantics, not the "
                "speed of N cards",
        **{name: {"wall_s": run["wall_s"], "ranks": [
            {"rank": r["rank"], "cell": r["cell"],
             **{d: {"ms": r[d]["ms"], "compare": r[d]["compare"],
                    "collectives": sp_per_step(r, d),
                    "epoch": r[d]["epoch"]} for d in DP_DTYPES}}
            for r in run["ranks"]]} for name, run in runs.items()},
        "launches": launched,
        "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    return line, launched


# ---- phase 8h: model parallel ------------------------------------------------

MP_WIDTHS = (2, 4)        # the sharded decode's rows ('mp' ranks)
MP_GRID = 2               # the (2 x 2) grid's row
MP_TIMEOUT_S = 600        # a launch, start to exit
MP_LP_TOL = 1e-5          # logprobs and scores against the replicated loop
MP_REPS = 5               # timed calls a rank, after the counted one
MP_FAULTS = ("local_argmax", "no_embed_sum", "topw_high_ties")
MP_PHASES = ("xe", "cst", "split", "beam")
# the epochs take dropout 0.5, keyed by the data coordinate
MP_OVER = {"model__dropout": 0.5}
MP_EPOCH_KEYS = (*(f"{n}_{k}" for n in ("xe", "cst", "split")
                   for k in ("params", "losses", "rollouts")),
                 "val_captions", "beam_captions", "beam_metrics")
MP_ROW_NOISE = 1e-3       # planted: mp-rank 1's loss scaled by 1 + this


def mp_inputs(model, dev, bf16: bool) -> dict:
    """The sharded decode's inputs at one bank dtype: the serving stride's
    (``stride_inputs``: capacity 32, K=2, S=8, every row's whole bank, no
    compaction) and beam-5 at the eval's B=64 (``beam_inputs`` on 64
    encoded clips, t=3), its row 0 all finished at equal scores: an exact
    tie of its W PAD continuations, which the top-W merge must break to
    the lower flat id."""
    x = stride_inputs(model, dev, bf16)
    cfg = model.cfg
    g = torch.Generator().manual_seed(9)
    clips = {"feats": {n: torch.randn((TRAIN_B, cfg.max_frames, d),
                                      generator=g).to(dev)
                       for n, d in cfg.modalities},
             "masks": {n: torch.ones((TRAIN_B, cfg.max_frames), device=dev)
                       for n, _ in cfg.modalities}}
    b = beam_inputs(model, clips, bf16, 3, 0)
    b["finished"][:, 0] = True
    b["scores"][:, 0] = -1.5
    return {"stride": {"carry": x["carry"], "token": x["token"],
                       "finished": x["finished"], "noise": x["noise"],
                       "bank": x["dense"]},
            "beam": {k: b[k] for k in ("carry", "token", "finished",
                                       "scores", "t", "min_len", "bank")}}


def mp_stride(model, x, mesh, w=None):
    s = x["stride"]
    return decode_mp.mp_decode_stride(
        model.cell, s["carry"], s["token"], s["finished"], *s["bank"],
        s["noise"], 0, mesh=mesh, steps=S, temperature=1.0, min_len=0,
        weights=w)


def mp_beam(model, x, mesh, w=None):
    b = x["beam"]
    return decode_mp.mp_beam_step(
        model.cell, b["carry"], b["token"], b["finished"], b["scores"],
        *b["bank"], mesh=mesh, t=b["t"], min_len=b["min_len"], weights=w)


@contextlib.contextmanager
def mp_planted(kind: str):
    """A fault planted in the sharded decode's merges, alike on every
    rank: the argmax merge given local, not global, indices; the
    embedding rows not summed over the row; the top-W merge breaking ties
    to the higher flat id."""
    if kind == "local_argmax":
        orig = decode_mp._merge_argmax

        def bad(vals, off, row):
            return orig(vals, 0, row)

        name = "_merge_argmax"
    elif kind == "no_embed_sum":
        def bad(table, token, off, row):
            owned, lic = decode_mp._owned(token, off, table.shape[0])
            return torch.where(owned[..., None], table[lic],
                               torch.zeros((), device=table.device))

        name = "_psum_embed"
    else:
        orig = decode_mp._merge_topw

        def bad(pool_s, pool_f, W):
            s, f = orig(pool_s, -pool_f, W)
            return s, -f

        name = "_merge_topw"
    with mock.patch.object(decode_mp, name, bad):
        yield


def mp_ms(fn, reps: int = MP_REPS) -> float:
    """A rank's median host ms of ``fn()`` (synchronised: the gloo merges
    and the card time-sliced between the ranks are in it)."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def mp_decode_width(model, xs: dict, mesh) -> dict:
    """This rank's sharded decode on ``mesh``'s 'mp' row: per bank dtype
    the stride and the beam step through ``ops/decode_mp.py`` on its
    vocabulary slice (packed once), their outputs, collectives, kernel-2
    launches and ms; on a row of 2 the planted faults' outputs."""
    from cst_captioning_tpu_torch.train import multihost

    mp = mesh.mp.world
    w = decode_mp.shard_weights(stride_weights(model.cell), mesh.mp.rank,
                                mp)
    res = {"rank": multihost.process_index(),
           "cell": (mesh.data.rank, mesh.mp.rank), "planted": {}}
    calls = {"stride": mp_stride, "beam": mp_beam}
    ops.reset_launches()
    with torch.no_grad():
        for dtype in DP_DTYPES:
            out = res[dtype] = {}
            for kind, fn in calls.items():
                decode_mp.reset_counts()
                before = fused_decode_step.launches
                r = fn(model, xs[dtype], mesh, w)
                torch.cuda.synchronize()
                out[kind] = [t.cpu() for t in r[1:]]
                out[f"{kind}_launches"] = fused_decode_step.launches - before
                out[f"{kind}_counts"] = dict(decode_mp.COUNTS)
        # the path's launches, read before the timed and planted calls
        res["launches"] = all_launches()
        for dtype in DP_DTYPES:
            for kind, fn in calls.items():
                res[dtype][f"{kind}_ms"] = mp_ms(
                    lambda: fn(model, xs[dtype], mesh, w))
        if mp == 2:
            for kind in MP_FAULTS:
                with mp_planted(kind):
                    res["planted"][kind] = {
                        k: [t.cpu() for t in fn(model, xs["float32"], mesh,
                                                w)[1:]]
                        for k, fn in calls.items()}
    return res


def mp_decode_rank(a: dict) -> dict:
    """A rank of part (a), on four ranks: the sharded decode on a row of
    4 (every rank), then on a row of 2 (the first row of a (2 x 2) grid
    decodes while the other waits, so the card serves one row at a
    time)."""
    from cst_captioning_tpu_torch.train import multihost
    from cst_captioning_tpu_torch.train.mesh import make_mesh

    dev = torch.device(DP_DEVICE)
    model = CaptionModel(model_config(), device=dev)
    model.load_state_dict(torch.load(a["model"], map_location=dev))
    model.eval()
    xs = torch.load(a["inputs"], map_location=dev)
    out = {}
    for mp in sorted(MP_WIDTHS, reverse=True):
        mesh = make_mesh(mp_devices=mp, device=DP_DEVICE)
        if mesh.data.rank == 0:
            out[f"mp{mp}"] = mp_decode_width(model, xs, mesh)
        multihost.barrier()
    return out


def mp_row_fault(data: dict, start: dict, mesh, row) -> list:
    """One XE step of the grid at float32 from the start weights on the
    first caption batch (this rank's rows), with the mp-rank-1 replicas'
    loss scaled by 1 + MP_ROW_NOISE (a backward that is not
    deterministic, planted) -> the params; ``row`` None skips the row's
    broadcast (the planted fault)."""
    from cst_captioning_tpu_torch.train import steps as steps_mod
    from cst_captioning_tpu_torch.train.mesh import batch_sharding

    cfg = dp_config("", "msrvtt_cst_consensus", "")
    mc = cfg.model
    ds = CaptionDataset(data["info_json"],
                        {n: data[n] for n, _ in mc.modalities}, "train",
                        mc.max_frames)
    batch = next(Batcher(ds, batch_size=TRAIN_B, max_len=mc.max_len,
                         mode="caption", host_shard=batch_sharding(mesh))
                 .epoch(shuffle=False))
    dev = torch.device(DP_DEVICE)
    up = lambda d: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                    for k, v in d.items()}
    model = load_flax_params(CaptionModel(mc, device=dev), start)
    state = create_train_state(model, make_optimizer(cfg.train, 1),
                               seed=cfg.train.seed)
    sums = steps_mod._local_loss_sums

    def perturbed(*args, **kw):
        num, den = sums(*args, **kw)
        return (num * (1 + MP_ROW_NOISE) if mesh.mp.rank == 1 else num), den

    step = steps_mod.make_parallel_xe_step(model, mesh.data, row=row)
    valid = torch.from_numpy(batch.valid.astype(np.float32)).to(dev)
    with mock.patch.object(steps_mod, "_local_loss_sums", perturbed):
        state, _ = step(state, up(batch.feats), up(batch.feat_masks),
                        torch.from_numpy(batch.labels).long().to(dev),
                        torch.from_numpy(batch.mask).float().to(dev),
                        xe_row_weights("xe", torch.from_numpy(
                            batch.weights).to(dev), valid))
    return [p.detach().clone() for p in state.params]


def mp_epochs_rank(rank: int, world: int, a: dict) -> dict:
    """A rank of part (b): the epochs (``dp_schedule``: XE, CST, the split
    RL epoch, beam-5 of the val clips) at each compute dtype, on two
    data-parallel ranks or on the (2 x 2) mp grid, their results saved
    for the parent's comparison; on the grid also the planted row fault.
    Deterministic algorithms on: the float32 gate is bitwise across two
    separate runs."""
    from cst_captioning_tpu_torch.parallel import comms
    from cst_captioning_tpu_torch.train import multihost
    from cst_captioning_tpu_torch.train.mesh import make_mesh

    root = os.path.join(a["root"], f"w{world}_rank{rank}")
    grid = world == 2 * MP_GRID
    mesh = make_mesh(mp_devices=MP_GRID if grid else 1, device=DP_DEVICE)
    res = {"cell": (mesh.data.rank, mesh.mp.rank) if grid else (rank, 0)}
    saved = {}
    ops.reset_launches()
    for dtype in DP_DTYPES:
        over = {**MP_OVER, **({"mesh__mp_devices": MP_GRID} if grid
                              else {})}
        comms.reset_row_counts()
        got = dp_schedule(os.path.join(root, dtype), a["data"], a["start"],
                          True, dtype, MP_PHASES, over)
        saved[dtype] = {k: got[k] for k in MP_EPOCH_KEYS}
        res[dtype] = {
            "wall_s": got["wall_s"], "row_broadcasts": dict(comms.ROW_COUNTS),
            "times": {n: {"s": got[f"{n}_s"],
                          "step_ms_median": got[f"{n}_step_ms"]}
                      for n in ("xe", "cst", "split")},
            "digests": {n: multihost.allgather_pyobj(
                _digest(got[f"{n}_params"])) for n in ("xe", "cst",
                                                       "split")}}
    res["launches"] = all_launches()
    torch.save(saved, a["results"].format(world=world, rank=rank))
    if grid:
        multihost.barrier()
        res["row_fault"] = {
            name: multihost.allgather_pyobj(_digest(mp_row_fault(
                a["data"], a["start"], mesh, row)))
            for name, row in (("broadcast", mesh.mp), ("skipped", None))}
    return res


def mp_epoch_equal(got: dict, want: dict) -> dict:
    """Each reference key of part (b): equal bit for bit."""
    out = {}
    for k in MP_EPOCH_KEYS:
        g, w = got.get(k), want.get(k)
        if isinstance(w, list) and w and isinstance(w[0], torch.Tensor):
            out[k] = len(g) == len(w) and all(
                torch.equal(x.cpu(), y.cpu()) for x, y in zip(g, w))
        else:
            out[k] = g == w
    return out


def mp_child(rank: int, world: int, init: str, a: dict,
             out_path: str) -> int:
    """One rank of a model_parallel launch: gloo on the card; part (a)'s
    sharded decode (``mp_decode``) or part (b)'s epochs (``mp_epochs``)
    -> a result pickle."""
    import pickle

    from cst_captioning_tpu_torch.train import multihost

    global DP_DEVICE, DP_MODEL
    DP_DEVICE, DP_MODEL = a["device"], a["model_over"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a["job"] == "mp_epochs":
        # cuBLAS reads this at its first handle; the index kernels of the
        # embedding's backward take their deterministic spelling
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    multihost.initialize(f"file://{init}", world_size=world, rank=rank,
                         backend="gloo", device=DP_DEVICE,
                         timeout_s=DP_GROUP_TIMEOUT_S)
    try:
        res = (mp_decode_rank(a) if a["job"] == "mp_decode"
               else mp_epochs_rank(rank, world, a))
        res["rank"] = rank
    finally:
        multihost.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    return 0


def mp_near_ok(tok: torch.Tensor, ref: torch.Tensor, gap: torch.Tensor):
    """Two token streams [S, G, B] -> (rows that diverge, rows whose first
    divergence is not at a near-tie of the plain version: top-2 gap above
    TIE_GAP) and the first-divergence mask for the logprobs."""
    diff = tok != ref
    diverged = diff.any(dim=0)
    first = diff.int().argmax(dim=0)
    bad = 0
    for g, b in diverged.nonzero().tolist():
        bad += int(float(gap[int(first[g, b]), g, b]) > TIE_GAP)
    upto = ~diverged[None] | (torch.arange(tok.shape[0])[:, None, None]
                              < first[None])
    return int(diverged.sum()), bad, upto


def mp_beam_near_bad(fl: torch.Tensor, ref: torch.Tensor,
                     psc: torch.Tensor) -> tuple[int, int]:
    """Beam candidates [B, W] against another version's [B, W] -> (rows
    that differ, candidates that differ away from a near-tie of the plain
    version's totals ``psc``, its first W + 1, within TOL), as
    ``compare_beam``."""
    W = fl.shape[1]
    gap = psc[:, :-1] - psc[:, 1:]
    near = gap <= TOL
    near[:, 1:] |= gap[:, :W - 1] <= TOL
    diff = fl != ref[:, :W]
    return int(diff.any(dim=1).sum()), int((diff & ~near).sum())


def mp_references(model, xs: dict) -> dict:
    """On this process, per bank dtype: the replicated kernel-2 loop (the
    sharded decode on a row of one rank: the JAX ``_reference_stride``
    semantics, no collective), kernels 3 and 5 on the same inputs, the
    plain versions' top-2 gaps and W + 1 candidates for the near-tie
    excuses; kernel 2 on each vocabulary slice against its columns of the
    whole vocabulary, bit for bit, at mp 2 and 4; the event ms of kernels
    3 and 5 and of the loop."""
    from cst_captioning_tpu_torch.train.mesh import DataMesh

    dev = model.device
    one = DataMesh("mp", 0, 1, dev)
    w = stride_weights(model.cell)
    out = {}
    with torch.no_grad():
        for dtype, x in xs.items():
            s, b = x["stride"], x["beam"]
            M = s["bank"][0].shape[1]
            B = s["token"].shape[1]
            full = torch.full((B,), M, dtype=torch.int32, device=dev)
            loop = [t.cpu() for t in mp_stride(model, x, one, w)[1:]]
            k3 = [t.cpu() for t in fused_decode_stride(
                model.cell, s["carry"], s["token"], s["finished"],
                *s["bank"], s["noise"], 0, steps=S, temperature=1.0,
                min_len=0, weights=w)[1:]]
            gap = decode_stride_plain(
                w, s["carry"], s["token"], s["finished"], *s["bank"],
                s["noise"], 0, B, steps=S, temperature=1.0, min_len=0,
                mem_lens=full, return_gap=True)[3].cpu()
            bloop = [t.cpu() for t in mp_beam(model, x, one, w)[1:]]
            k5 = [t.cpu() for t in fused_beam_step(
                model.cell, b["carry"], b["token"], b["finished"],
                b["scores"], *b["bank"], t=b["t"], min_len=b["min_len"],
                weights=w)[1:]]
            _, logits = decode_step_plain(w, b["carry"],
                                          w.embt[b["token"].long()],
                                          *b["bank"])
            psc, pfl = beam_topk_plain(logits, b["finished"], b["scores"],
                                       t=b["t"], min_len=b["min_len"],
                                       width=BEAM_W + 1)
            bitwise = {}
            for kind, y in (("stride", s), ("beam", b)):
                emb = w.embt[y["token"].long()]
                dt = y["carry"][0][0].dtype
                whole = fused_decode_step_(
                    model.cell, stack_carry(y["carry"]), y["token"],
                    *y["bank"], dt, emb=emb, weights=w)
                for mp in MP_WIDTHS:
                    vs = model.cfg.vocab_size // mp
                    bitwise[f"{kind}_mp{mp}"] = all(torch.equal(
                        fused_decode_step_(
                            model.cell, stack_carry(y["carry"]), y["token"],
                            *y["bank"], dt, emb=emb,
                            weights=decode_mp.shard_weights(w, k, mp)),
                        whole[..., k * vs:(k + 1) * vs]) for k in range(mp))
            times = time_in_turns({
                "loop": (lambda: mp_stride(model, x, one, w),
                         lambda: fused_decode_stride(
                             model.cell, s["carry"], s["token"],
                             s["finished"], *s["bank"], s["noise"], 0,
                             steps=S, temperature=1.0, min_len=0,
                             weights=w)),
                "beam": (lambda: mp_beam(model, x, one, w),
                         lambda: fused_beam_step(
                             model.cell, b["carry"], b["token"],
                             b["finished"], b["scores"], *b["bank"],
                             t=b["t"], min_len=b["min_len"], weights=w))})
            out[dtype] = {"loop": loop, "k3": k3, "gap": gap,
                          "beam_loop": bloop, "k5": k5, "psc": psc.cpu(),
                          "pfl": pfl.cpu(), "bitwise": bitwise,
                          "ms": {"replicated_loop": times["loop"][0],
                                 "kernel3": times["loop"][1],
                                 "replicated_beam": times["beam"][0],
                                 "kernel5": times["beam"][1]}}
    return out


def mp_gate_decode(mp: int, rank: dict, ref: dict) -> dict:
    """One rank's sharded decode against the references, through the
    gates (module docstring, 8h (a)) -> its readings."""
    read = {}
    for dtype in DP_DTYPES:
        x, r = rank[dtype], ref[dtype]
        where = f"model_parallel mp={mp} rank {rank['rank']} {dtype}"
        tok, lp = x["stride"]
        check(torch.equal(tok, r["loop"][0]),
              f"{where}: stride tokens differ from the replicated loop")
        lp_err = float((lp - r["loop"][1]).abs().max())
        check(lp_err <= MP_LP_TOL, f"{where}: logprobs {lp_err:.3e}")
        div3, bad3, upto = mp_near_ok(tok, r["k3"][0], r["gap"])
        check(bad3 == 0, f"{where}: {bad3} rows diverge from kernel 3 away "
              f"from a near-tie")
        lp3 = float((lp - r["k3"][1]).abs()[upto].max())
        check(lp3 <= TOL, f"{where}: logprobs vs kernel 3 {lp3:.3e}")
        sc, fl = x["beam"]
        check(torch.equal(fl, r["beam_loop"][1]),
              f"{where}: beam candidates differ from the replicated loop")
        sc_err = float((sc - r["beam_loop"][0]).abs().max())
        check(sc_err <= MP_LP_TOL, f"{where}: beam scores {sc_err:.3e}")
        divp, badp = mp_beam_near_bad(fl, r["pfl"], r["psc"])
        check(badp == 0, f"{where}: {badp} beam candidates differ from "
              "the plain beam step away from a near-tie")
        div5, bad5 = mp_beam_near_bad(fl, r["k5"][1], r["psc"])
        check(bad5 == 0, f"{where}: {bad5} beam candidates differ from "
              "kernel 5 away from a near-tie")
        sc5 = float((sc - r["k5"][0]).abs().max())
        check(sc5 <= TOL + TOL * float(r["k5"][0].abs().max()),
              f"{where}: beam scores vs kernel 5 {sc5:.3e}")
        check(x["stride_launches"] == S and x["beam_launches"] == 1,
              f"{where}: kernel 2 launched {x['stride_launches']} times a "
              f"stride, {x['beam_launches']} a beam step")
        sc_calls = sum(v for k, v in x["stride_counts"].items()
                       if not k.endswith("_bytes"))
        check(sc_calls == 8 * S, f"{where}: {sc_calls} collectives a "
              f"stride of {S} steps, not 8 a step")
        read[dtype] = {
            "stride_lp_err": lp_err, "k3_rows_diverged": div3,
            "k3_lp_err": lp3, "beam_score_err": sc_err,
            "plain_beam_rows_differ": divp, "k5_rows_differ": div5,
            "k5_score_err": sc5,
            "kernel2_launches": {"stride": x["stride_launches"],
                                 "beam": x["beam_launches"]},
            "stride_step": {
                "collectives": sc_calls / S,
                "bytes": sum(v for k, v in x["stride_counts"].items()
                             if k.endswith("_bytes")) / S},
            "beam_step": {
                "collectives": sum(v for k, v in x["beam_counts"].items()
                                   if not k.endswith("_bytes")),
                "bytes": sum(v for k, v in x["beam_counts"].items()
                             if k.endswith("_bytes"))},
            "ms": {"stride": x["stride_ms"], "beam": x["beam_ms"]}}
    return read


MP_EPOCH_CLIPS = 3 * TRAIN_B   # part (b)'s train clips: 3 steps an epoch


def epoch_corpus(data: dict, root: str, n_train: int) -> dict:
    """``data`` with its train split cut to its first ``n_train`` clips
    (a new info json under ``root``; val and test whole)."""
    info = json.load(open(data["info_json"]))
    train = [v for v in info["videos"] if v["split"] == "train"]
    keep = {v["id"] for v in train[:n_train]}
    path = os.path.join(root, f"info_train{n_train}.json")
    with open(path, "w") as f:
        json.dump(dict(info, videos=[v for v in info["videos"]
                                     if v["split"] != "train"
                                     or v["id"] in keep]), f)
    return dict(data, info_json=path)


def model_parallel_phase(root: str, data: dict, start: dict, smi: str
                         ) -> tuple[dict, dict]:
    """Model parallelism (module docstring, 8h) on the data_parallel
    phase's corpus, its train split cut to MP_EPOCH_CLIPS, and start
    weights -> (its line, the launches of its runs)."""
    try:
        return _model_parallel(root, epoch_corpus(data, root,
                                                  MP_EPOCH_CLIPS),
                               start, smi)
    finally:
        tobs.shutdown()


def _model_parallel(root: str, data: dict, start: dict, smi: str
                    ) -> tuple[dict, dict]:
    t_phase = time.perf_counter()
    dev = torch.device(DP_DEVICE)
    model = make_model(dev)
    xs = {d: mp_inputs(model, dev, d == "bfloat16") for d in DP_DTYPES}
    t = time.perf_counter()
    ref = mp_references(model, xs)
    ref_s = time.perf_counter() - t
    paths = {"model": os.path.join(root, "mp_model.pt"),
             "inputs": os.path.join(root, "mp_inputs.pt")}
    torch.save(model.state_dict(), paths["model"])
    torch.save(xs, paths["inputs"])
    del model, xs
    torch.cuda.empty_cache()
    base = {"device": DP_DEVICE, "model_over": DP_MODEL, **paths}
    launched = dict.fromkeys(SOURCE, 0)
    ranks, a_wall = spawn_ranks(root, {**base, "job": "mp_decode"},
                                max(MP_WIDTHS), "model_parallel (a)",
                                MP_TIMEOUT_S)
    decode = {"wall_s": a_wall}
    for mp in MP_WIDTHS:
        row = [r[f"mp{mp}"] for r in ranks if f"mp{mp}" in r]
        check(sorted(r["cell"] for r in row) == [(0, k) for k in range(mp)],
              f"model_parallel mp={mp}: cells {[r['cell'] for r in row]}")
        decode[f"mp{mp}"] = {"ranks": [{"rank": r["rank"],
                                        **mp_gate_decode(mp, r, ref)}
                                       for r in row]}
        for r in row:
            for k, v in r["launches"].items():
                launched[k] += v
        planted = {}
        for kind, got in row[0]["planted"].items():
            f32 = ref["float32"]
            stride_ok = torch.equal(got["stride"][0], f32["loop"][0])
            beam_ok = torch.equal(got["beam"][1], f32["beam_loop"][1])
            gate = beam_ok if kind == "topw_high_ties" else stride_ok
            check(not gate, f"model_parallel: planted {kind} passed its gate")
            planted[kind] = {"stride_tokens_equal": stride_ok,
                             "beam_ids_equal": beam_ok}
        if planted:
            decode[f"mp{mp}"]["planted"] = planted
    for dtype in DP_DTYPES:
        check(all(ref[dtype]["bitwise"].values()),
              f"model_parallel {dtype}: kernel 2 on a vocabulary slice is "
              f"not bitwise its columns of the whole {ref[dtype]['bitwise']}")
    # part (b): the (2 x 2) grid and two data-parallel ranks, launched
    # together (their times are the card time-sliced between six ranks)
    a = {**base, "job": "mp_epochs", "root": os.path.join(root, "mp"),
         "data": data, "start": start,
         "results": os.path.join(root, "mp_w{world}_rank{rank}.pt")}
    t = time.perf_counter()
    hs = {name: start_ranks(root, a, world, f"model_parallel (b) {name}",
                            MP_TIMEOUT_S)
          for world, name in ((MP_GRID, "dp"), (2 * MP_GRID, "2x2"))}
    epochs = {name: dict(zip(("ranks", "wall_s"), finish_ranks(h)))
              for name, h in hs.items()}
    b_wall = time.perf_counter() - t
    for e in epochs.values():
        for r in e["ranks"]:
            for k, v in r["launches"].items():
                launched[k] += v
    layout = dp_layout(start)
    for r in epochs["2x2"]["ranks"]:
        where = f"model_parallel 2x2 rank {r['rank']} {r['cell']}"
        d = r["cell"][0]
        got = torch.load(a["results"].format(world=4, rank=r["rank"]),
                         map_location="cpu")
        want = torch.load(a["results"].format(world=2, rank=d),
                          map_location="cpu")
        for dtype in DP_DTYPES:
            x = r[dtype]
            for n, dg in x["digests"].items():
                check(dg[2 * d] == dg[2 * d + 1],
                      f"{where} {dtype}: its row's {n} params differ")
            x["equal"] = mp_epoch_equal(got[dtype], want[dtype])
            g, w_ = got[dtype], want[dtype]
            if dtype == "float32" or r["cell"][1]:
                continue
            # bfloat16, reported once a row: how far it sits from the
            # data-parallel rank where it is not bitwise
            x["compare"] = {
                "params": {n: dp_close(g[f"{n}_params"], w_[f"{n}_params"],
                                       None, layout)
                           for n in ("xe", "cst", "split")},
                "rollout_rows_equal": {n: dp_rows_equal(
                    g[f"{n}_rollouts"], w_[f"{n}_rollouts"])
                    for n in ("cst", "split")},
                "val_agreement": dp_caption_agreement(g["val_captions"],
                                                      w_["val_captions"])}
        bad = [k for k, ok in r["float32"]["equal"].items() if not ok]
        check(not bad, f"{where}: float32 not bitwise the data-parallel "
              f"rank's: {bad}")
        del got, want
        rf = r["row_fault"]
        check(rf["broadcast"][2 * d] == rf["broadcast"][2 * d + 1],
              f"{where}: the row broadcast left a perturbed replica apart")
        check(rf["skipped"][2 * d] != rf["skipped"][2 * d + 1],
              f"{where}: planted (row broadcast skipped) passed its gate")
    line = {
        "phase": "model_parallel", "preset": "msrvtt_xe_attention",
        "widths": list(MP_WIDTHS),
        "vocab_a_shard": {f"mp{mp}": model_config().vocab_size // mp
                          for mp in MP_WIDTHS},
        "stride": {"capacity": CAPACITY, "K": K, "steps": S},
        "beam": {"W": BEAM_W, "B": TRAIN_B},
        "bounds": {"loop": MP_LP_TOL, "kernels_3_5": TOL,
                   "tie_gap": TIE_GAP},
        "references": {d: {"ms": ref[d]["ms"],
                           "kernel2_slice_bitwise": ref[d]["bitwise"]}
                       for d in DP_DTYPES},
        "references_s": ref_s, "decode": decode, "epochs_wall_s": b_wall,
        "epochs": {name: {"wall_s": e["wall_s"], "ranks": [
            {"rank": r["rank"], "cell": r["cell"],
             **{dt: {k: v for k, v in r[dt].items() if k != "digests"}
                for dt in DP_DTYPES},
             **({"row_fault_rows_equal": {
                 k: [v[0] == v[1], v[2] == v[3]]
                 for k, v in r["row_fault"].items()}}
                if "row_fault" in r else {})}
            for r in e["ranks"]]} for name, e in epochs.items()},
        "note": "gloo ranks time-sliced on one card: semantics and the "
                "merges' host cost, not the speed of N cards",
        "launches": launched,
        "wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    return line, launched


def scst_setup(corpus: dict, dev) -> tuple:
    """Phase 6's model fitted on ``corpus`` (its model_fit line printed),
    trainer and state -> (scfg, model, trainer, state)."""
    scfg = scst_config()
    srl = scfg.rl
    t = time.perf_counter()
    smodel, fit_loss = fitted_model(scfg, corpus, dev)
    emit({"phase": "model_fit", "for": "scst", "steps": FIT_STEPS,
          "lr": FIT_LR, "last_loss": fit_loss, "s": time.perf_counter() - t})
    s_reward = RewardComputer(
        corpus["vocab"], corpus["gts"], cider_weight=srl.reward_cider_weight,
        bleu_weight=srl.reward_bleu4_weight, bleu_scale=srl.reward_bleu4_scale,
        num_threads=srl.reward_threads)
    s_trainer = SCSTTrainer(smodel, s_reward, srl, guard=True)
    s_state = create_train_state(
        smodel, make_optimizer(scfg.train, 1, lr_override=srl.lr),
        seed=scfg.train.seed)
    return scfg, smodel, s_trainer, s_state


def scst_line(scfg, sc: dict, smi: str) -> dict:
    srl = scfg.rl
    return {"phase": "train_scst", "preset": scfg.name, "batch": TRAIN_B,
            "rollouts": srl.num_rollouts, "baseline": srl.baseline,
            "stride": scfg.model.decode_stride, **sc, "nvidia_smi": smi}


# ---- phase 6f: the runtime cross-check of the lint's sync rules ---------------

SYNC_REQUESTS = 16
SYNC_GATED = tuple(f"cst_captioning_tpu_torch/{p}/"
                   for p in ("train", "rl", "decoding", "ops"))
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def sync_watch(sites: dict):
    """Run the block under ``torch.cuda.set_sync_debug_mode("warn")`` and
    count each synchronizing call into ``sites`` by its repo-relative
    ``path:line`` (the Python line that made the call); the mode is off
    again when the block ends, however it ends."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        path = os.path.relpath(os.path.abspath(w.filename), REPO_DIR)
        key = f"{path.replace(os.sep, '/')}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1


def lint_sites() -> dict[tuple[str, int], str]:
    """(path, line) -> rule ids of every finding of the port's lint in the
    gated packages, baselined ones included (stdlib only: no torch). The
    index covers the package; the rules run on the gated files."""
    from cst_captioning_tpu_torch.tools.graftlint import Baseline, lint_paths
    from cst_captioning_tpu_torch.tools.graftlint.core import (
        BASELINE_NAME,
        iter_py_files,
    )

    gated = list(iter_py_files(
        [os.path.join(REPO_DIR, g) for g in SYNC_GATED]))
    res = lint_paths([os.path.join(REPO_DIR, "cst_captioning_tpu_torch")],
                     REPO_DIR,
                     baseline=Baseline.load(os.path.join(REPO_DIR,
                                                         BASELINE_NAME)),
                     cache_path="", only_files=gated)
    out: dict[tuple[str, int], str] = {}
    for f in res.findings:
        key = (f.path, f.line)
        out[key] = ",".join(sorted(set(out.get(key, "").split(",")) - {""}
                                   | {f.rule + ("(b)" if f.baselined
                                                else "")}))
    return out


def syncs_phase(model, reqs, tcfg, corpus, tmodel, s_trainer, smodel,
                scfg, smi: str) -> dict:
    """Phase 6f: one serve burst of SYNC_REQUESTS at full width, one XE
    step and one SCST step under sync debug mode, each synchronizing call
    recorded by site; every site in the port's train/, rl/, decoding/ or
    ops/ must be a finding of the port's lint (new or baselined). The XE
    and SCST steps run on clones of their states, so neither model
    moves. One stride of a composite serve of the same burst is watched
    too, and its sites reported without the gate."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    burst = reqs[:SYNC_REQUESTS]
    service(model).serve(burst[:4])          # first-call costs stay out
    svc = service(model)
    step = make_xe_step(tmodel, tcfg.train.label_smoothing, guard=True)
    xe_state = create_train_state(
        tmodel, make_optimizer(tcfg.train, steps_per_epoch=1),
        seed=tcfg.train.seed).clone()
    batch = xe_batch(tcfg, corpus, 0, dev)
    s_state = create_train_state(
        smodel, make_optimizer(scfg.train, 1, lr_override=scfg.rl.lr),
        seed=scfg.train.seed).clone()
    serve_sites: dict = {}
    xe_sites: dict = {}
    scst_sites: dict = {}
    t = time.perf_counter()
    with sync_watch(serve_sites):
        rep = svc.serve(burst)
    with sync_watch(xe_sites):
        xe_state, m = step(xe_state, *batch)
    with sync_watch(scst_sites):
        s_state, sm = s_trainer.train_step(
            s_state, corpus["feats"], corpus["masks"], corpus["vids"],
            seed=900)
    watched_s = time.perf_counter() - t
    # one stride of a composite service (the second: admissions done),
    # reported by site and not gated, like the serve's
    cmodel = composite_model(dev)
    service(cmodel).serve(burst[:4])
    csvc = service(cmodel)
    comp_sites: dict = {}
    run_stride = csvc._run_stride

    def watched(report, now):
        if report.strides == 1:
            with sync_watch(comp_sites):
                run_stride(report, now)
        else:
            run_stride(report, now)

    csvc._run_stride = watched
    crep = csvc.serve(burst)
    del cmodel, csvc
    check(torch.cuda.get_sync_debug_mode() == 0,
          "syncs: sync debug mode still on after the phase")
    check(rep.completed == SYNC_REQUESTS and np.isfinite(m["loss"])
          and np.isfinite(sm["rl_loss"]),
          f"syncs: the watched paths did not finish cleanly ({rep.completed}"
          f" requests, XE loss {m['loss']}, rl_loss {sm['rl_loss']})")
    check(crep.completed == SYNC_REQUESTS and crep.strides > 1,
          f"syncs: the composite serve completed {crep.completed} in "
          f"{crep.strides} strides")
    t = time.perf_counter()
    lint = lint_sites()
    lint_s = time.perf_counter() - t
    covered, missed = {}, []
    for sites in (serve_sites, xe_sites, scst_sites):
        for key in sites:
            path, _, line = key.rpartition(":")
            if not path.startswith(SYNC_GATED):
                continue
            rules = lint.get((path, int(line)))
            if rules:
                covered[key] = rules
            else:
                missed.append(key)
    check(not missed, f"syncs: sites the port's lint misses: {missed}")

    def per(sites: dict, n: int) -> dict:
        return {"total": sum(sites.values()), "per_unit": sum(
            sites.values()) / max(n, 1), "by_site": dict(sorted(
                sites.items(), key=lambda kv: -kv[1]))}

    return {"phase": "syncs", "serve_requests": SYNC_REQUESTS,
            "serve_strides": rep.strides,
            "serve": per(serve_sites, rep.strides),
            "xe_step": per(xe_sites, 1), "scst_step": per(scst_sites, 1),
            "composite_stride": per(comp_sites, 1),
            "scst_decode_steps": sm["decode_steps"],
            "gated_sites_covered": covered, "gated_sites_missed": missed,
            "watched_s": watched_s, "lint_s": lint_s,
            "phase_s": time.perf_counter() - t0, "nvidia_smi": smi}


# ---- phase 6g: bfloat16 parameters --------------------------------------------

BF16P_DEVICE = "cuda"
BF16P_SERVE = 16          # the serve burst's requests served by each model
BF16P_BEAM = 8            # clips of the beam-5 check
BF16P_CPU_B = 16          # clips of the XE step held against the CPU's
BF16P_XE_STEPS = 3
BF16P_PACKS = 20          # timed stride_weights packs, each dtype


def bf16p_models(mc, tree, dev):
    """-> (the bf16-param model, the float32-param model holding the same
    bf16-rounded values), both in eval mode: ``tree`` in a float32 model,
    its state dict ``.to(torch.bfloat16)`` into a bf16 one, and that
    widened back into the float32 model."""
    f32 = load_flax_params(CaptionModel(dataclasses.replace(
        mc, param_dtype="float32"), device=dev), tree)
    b16 = CaptionModel(dataclasses.replace(mc, param_dtype="bfloat16"),
                       device=dev)
    b16.load_state_dict({k: v.to(torch.bfloat16)
                         for k, v in f32.state_dict().items()})
    f32.load_state_dict(b16.state_dict())
    return b16.eval(), f32.eval()


def bf16p_equal(a, b) -> bool:
    """Bitwise equality of tensors, arrays or tuples of them."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bf16p_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return np.array_equal(a, b)


def bf16p_paths(b16, f32, tcfg, corpus, reqs) -> dict:
    """Phase 6g (a): each path on the bf16 model and on the float32 one
    -> {path: bitwise equal}."""
    dev = b16.device
    feats, masks = corpus["feats"], corpus["masks"]
    labels = xe_batch(tcfg, corpus, 0, dev)[2]
    few = {n: x[:BF16P_BEAM] for n, x in feats.items()}
    few_m = {n: x[:BF16P_BEAM] for n, x in masks.items()}
    out = {}
    with torch.no_grad():
        runs = {
            "xe_logits": lambda m: m(feats, masks, labels),
            "cst_sample_k2": lambda m: decoding_sample.sample_decode(
                m, feats, masks, seed=5, num_rollouts=tcfg.rl.num_rollouts),
            "scst_stride_k3": lambda m: decoding_fused.fused_decode(
                m, feats, masks, seed=6, num_rollouts=1),
            "beam5_k5": lambda m: beam_search(m, few, few_m, beam_size=BEAM_W),
        }
        for key, run in runs.items():
            out[key] = bf16p_equal(run(b16), run(f32))
    got = [service(m).serve(reqs[:BF16P_SERVE]) for m in (b16, f32)]
    out["serve_k4"] = all(
        np.array_equal(r.tokens, got[1].results[i].tokens)
        and np.array_equal(r.logprobs, got[1].results[i].logprobs)
        for i, r in got[0].results.items()) and \
        got[0].completed == BF16P_SERVE
    return out


def bf16p_inputs(b16, corpus, dev) -> dict:
    """Kernels 2-5's inputs at phase 2's shapes on the bf16 model (its
    bf16 weight pack in ``w``): the serve stride (capacity 32, K=2, S=8;
    dense and paged), the SCST stride (B=64, K=1), the decode step at G=5
    and G=1, the beam step (W=5, B=64)."""
    serve = stride_inputs(b16, dev, True)
    return {"fused_decode_stride": serve, "fused_decode_stride_paged": serve,
            "fused_decode_stride_scst": stride_inputs(b16, dev, True, seed=6,
                                                      B=TRAIN_B, K=1),
            "fused_decode_step": step_inputs(b16, corpus, True),
            "fused_decode_step_g1": step_inputs(b16, corpus, True, G=1),
            "fused_beam_step": beam_inputs(b16, corpus, True, 3, 0)}


def bf16p_kernels(b16, corpus, xs) -> dict:
    """Phase 6g (b): kernels 1-5 against their plain versions on the bf16
    model's bf16 weight pack, at phase 2's shapes and tolerances ->
    largest errors."""
    err = {}
    for key, x in xs.items():
        name = key.replace("_scst", "").replace("_g1", "")
        if name == "fused_decode_step":
            res = compare_step(b16, x)
        elif name == "fused_beam_step":
            res = compare_beam(b16, x)
        else:
            res = compare(name, b16, x)
        err[name] = max(err.get(name, 0.0), res["max_abs_err"])
    err["fused_additive_attention"] = compare_attention(attention_inputs(
        b16, corpus, torch.bfloat16, TRAIN_B))["max_abs_err"]
    return err


BF16P_KERNELS = ("fused_decode_step", "fused_decode_stride",
                 "fused_decode_stride_paged", "fused_beam_step")


def pack_bytes(w) -> int:
    return sum(getattr(w, n).numel() * getattr(w, n).element_size()
               for n in PACK_FIELDS)


QUEUE_SLEEP_CYCLES = 100_000_000   # about 50 ms of the card's clock


def queued_device_ms(fn, reps: int = 10) -> float:
    """Device ms a call of ``fn`` takes: CUDA events around ``reps`` calls
    queued behind a sleep kernel, so the host's launch time stays off the
    device's timeline (the wrapper's own device work, a gather or a cast,
    included). The calls must be queued before the sleep ends. Late in the
    whole script torch.profiler lost a share of these calls' launches."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    ev[2].synchronize()
    check(host_ms < ev[0].elapsed_time(ev[1]),
          f"queued_device_ms: the calls took {host_ms:.1f} ms to queue, "
          "longer than the sleep ahead of them")
    return ev[1].elapsed_time(ev[2]) / reps


def bf16p_runner(key: str, model, x, w):
    """-> (a call of ``key``'s kernel on ``x`` with the pack ``w`` that
    returns every output, a step's or beam step's carry stepped on a fresh
    stack so calls are independent; the call phase 2 times, which steps
    ``x``'s own stack in place)."""
    xw = dict(x, w=w)
    if "stride" in key:
        name = key.replace("_scst", "")
        run = lambda: run_kernel(name, model, xw)  # noqa: E731
        return run, run
    step = run_beam_kernel if "beam" in key else run_step_kernel

    def fresh():
        state = stack_carry(x["carry"])
        return step(model, xw, state), state
    return fresh, lambda: step(model, xw)


def bf16p_weight_packs(b16, f32, xs, corpus, smi: str) -> dict:
    """Phase 6g (e): kernels 2-5 on the bf16 model's bf16 weight pack and
    on the float32 pack of the same values (the float32 model's), at
    phase 2's shapes: bitwise equal outputs; event ms in turns (each pack
    beside the other) and device ms (``queued_device_ms``); the packs'
    bytes; the peak memory of
    one greedy decode (G=1, the 64 clips) of each model."""
    from cst_captioning_tpu_torch.decoding import greedy_decode

    wb, wf = stride_weights(b16.cell), stride_weights(f32.cell)
    check(wb.dtype == torch.bfloat16 and wf.dtype == torch.float32
          and all(torch.equal(getattr(wb, n).float(), getattr(wf, n))
                  for n in PACK_FIELDS),
          "param_bf16 (e): the packs are not bf16 and its float32 values")
    nb, nf = pack_bytes(wb), pack_bytes(wf)
    check(2 * nb == nf, f"param_bf16 (e): pack bytes {nb} bf16, {nf} f32")
    out = {"pack_bytes": {"bfloat16": nb, "float32": nf}, "bitwise": {}}
    timed = {}
    for key, x in xs.items():
        (rb, tb), (rf, tf) = (bf16p_runner(key, b16, x, w) for w in (wb, wf))
        same = bf16p_equal(rb(), rf())
        out["bitwise"][key] = same
        check(same, f"param_bf16 (e): {key} on the bf16 pack differs from "
              "the float32 pack's")
        timed[key] = (tb, tf)
    times = time_in_turns(timed)
    for key, fns in timed.items():
        dev_ms = [queued_device_ms(t) for t in fns]
        out[key] = {"bf16_pack_ms": times[key][0],
                    "f32_pack_ms": times[key][1],
                    "bf16_pack_device_ms": dev_ms[0],
                    "f32_pack_device_ms": dev_ms[1]}
    peak = {}
    for dtype, m in (("bfloat16", b16), ("float32", f32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        with torch.no_grad():
            greedy_decode(m, corpus["feats"], corpus["masks"])
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        peak[dtype] = {"peak_bytes": top, "above_start_bytes": top - start}
    out["greedy_max_memory_allocated"] = peak
    out["nvidia_smi"] = smi
    return out


def bf16p_launches() -> dict:
    """Kernels 2-5's launches on a bf16 weight pack since the last
    reset."""
    return {"fused_decode_step": fused_decode_step.launches_bf16,
            "fused_decode_stride": fused_decode_stride.launches_bf16,
            "fused_decode_stride_paged":
                fused_decode_stride_paged.launches_bf16,
            "fused_beam_step": fused_beam_step.launches_bf16}


def bf16p_bytes(state) -> int:
    """Parameter and Adam-moment bytes: numel x element size."""
    return sum(t.numel() * t.element_size()
               for t in state.params + state.opt_state["mu"]
               + state.opt_state["nu"])


# card vs CPU, one bf16-param XE step from zero moments: the first moment
# is mu = 0.1 g (the clipped gradient) and nu = 0.001 g^2, so the moments
# carry what the step computed; Adam's first update is about lr an element
# whatever the gradient, so the parameters carry little. (mu, nu) bounds:
# each leaf's element errors over its largest value, each leaf's relative
# L2 distance, the whole tree's (the CPU tests' moments_close)
BF16P_ELEM = (2.0 ** -4, 2.0 ** -3)
BF16P_LEAF_L2 = (2.0 ** -4, 2.0 ** -3)
BF16P_TREE_L2 = (2.0 ** -6, 2.0 ** -5)
BF16P_LOSS = 2.0 ** -10         # relative
BF16P_GRAD_NORM = 2.0 ** -8     # relative


def moments_close(ref, other, which: int) -> tuple[bool, dict]:
    """Two lists of one Adam moment (``which``: 0 mu, 1 nu) as float32 CPU
    tensors -> (within the BF16P bounds, the worst element error over its
    leaf's largest value, the worst leaf's and the tree's relative L2
    distances)."""
    worst = {"elem": 0.0, "leaf_l2": 0.0}
    d2 = w2 = 0.0
    for w, g in zip(ref, other):
        d = (g - w).abs().double()
        top = max(float(w.abs().max()), 1e-30)
        worst["elem"] = max(worst["elem"], float(d.max()) / top)
        worst["leaf_l2"] = max(worst["leaf_l2"], float(
            d.norm() / max(float(w.double().norm()), 1e-30)))
        d2 += float((d * d).sum())
        w2 += float((w.double() ** 2).sum())
    worst["tree_l2"] = (d2 / max(w2, 1e-60)) ** 0.5
    ok = (worst["elem"] <= BF16P_ELEM[which]
          and worst["leaf_l2"] <= BF16P_LEAF_L2[which]
          and worst["tree_l2"] <= BF16P_TREE_L2[which])
    return ok, worst


def bf16p_step_close(ref: dict, other: dict) -> tuple[bool, dict]:
    """Two XE steps' results (:func:`bf16p_xe_step`) -> (the loss, grad
    norm, mu and nu within their BF16P bounds, what was read)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    read = {"loss_rel": rel(other["loss"], ref["loss"]),
            "grad_norm_rel": rel(other["grad_norm"], ref["grad_norm"])}
    ok = read["loss_rel"] <= BF16P_LOSS and \
        read["grad_norm_rel"] <= BF16P_GRAD_NORM
    for which, m in enumerate(("mu", "nu")):
        good, read[m] = moments_close(ref[m], other[m], which)
        ok = ok and good
    return ok, read


def bf16p_xe_step(mc, tree, tcfg, b, dev, rows) -> dict:
    """One guarded XE step of the bf16-param model on ``dev`` over ``rows``
    of the batch ``b`` -> its loss, grad norm, params, mu and nu (float32
    CPU tensors)."""
    model = load_flax_params(CaptionModel(mc, device=dev), tree)
    state = create_train_state(model, make_optimizer(tcfg.train, 1),
                               seed=tcfg.train.seed)
    batch = ({n: x[rows].to(dev) for n, x in b[0].items()},
             {n: x[rows].to(dev) for n, x in b[1].items()},
             *(x[rows].to(dev) for x in b[2:]))
    state, m = make_xe_step(model, 0.0, guard=True)(state, *batch)
    check(m["nonfinite"] == 0.0, f"param_bf16 (c): {dev} step {m}")
    f32 = lambda ts: [t.detach().cpu().float() for t in ts]  # noqa: E731
    return {"loss": m["loss"], "grad_norm": m["grad_norm"],
            "params": f32(state.params), "mu": f32(state.opt_state["mu"]),
            "nu": f32(state.opt_state["nu"])}


def bf16p_vs_cpu(mc, tree, tcfg, corpus) -> dict:
    """Phase 6g (c2): one XE step (dropout 0: the two devices draw other
    masks) on the card and by the port on the CPU from the same bf16
    params, held by :func:`bf16p_step_close`; and two controls the gate
    must refuse: the card's step on the first half of the clips, and the
    card's moments scaled by 1.05."""
    mc = dataclasses.replace(mc, param_dtype="bfloat16", dropout=0.0)
    card = torch.device(BF16P_DEVICE)
    b = xe_batch(tcfg, corpus, 0, card)
    rows = slice(0, BF16P_CPU_B)
    got = bf16p_xe_step(mc, tree, tcfg, b, card, rows)
    cpu = bf16p_xe_step(mc, tree, tcfg, b, torch.device("cpu"), rows)
    ok, read = bf16p_step_close(cpu, got)
    half = bf16p_xe_step(mc, tree, tcfg, b, card,
                         slice(0, BF16P_CPU_B // 2))
    half_ok, half_read = bf16p_step_close(cpu, half)
    scaled = dict(got, mu=[t * 1.05 for t in got["mu"]],
                  nu=[t * 1.05 for t in got["nu"]])
    scaled_ok, scaled_read = bf16p_step_close(cpu, scaled)
    n = sum(t.numel() for t in got["params"])
    share = lambda k: sum(int((a == c).sum()) for a, c in zip(  # noqa: E731
        got[k], cpu[k])) / n
    return {"ok": ok, "read": read, "elements": n,
            "bitwise_share": {k: share(k) for k in ("params", "mu", "nu")},
            "loss_card": got["loss"], "loss_cpu": cpu["loss"],
            "grad_norm_card": got["grad_norm"],
            "grad_norm_cpu": cpu["grad_norm"],
            "control_half_batch": {"refused": not half_ok,
                                   "read": half_read},
            "control_scaled_1.05": {"refused": not scaled_ok,
                                    "read": scaled_read}}


def bf16p_pack_ms(b16, f32) -> dict:
    """stride_weights on each model: CUDA-event ms a pack (the decode and
    the SCST step pack once a decode; serving once a version)."""
    out = {}
    for key, m in (("bfloat16", b16), ("float32", f32)):
        times = event_times(lambda m=m: stride_weights(m.cell),
                            reps=BF16P_PACKS)
        out[key] = float(np.median(times))
    return out


def param_bf16_phase(tcfg, corpus, reqs, smi: str) -> tuple[dict, dict]:
    """Phase 6g (module docstring) -> (its line, the launches of (a) and
    (c))."""
    t0 = time.perf_counter()
    dev = torch.device(BF16P_DEVICE)
    line = {"phase": "param_bf16", "preset": tcfg.name}
    tree = train_tree(tcfg.model, corpus)
    launched = {k: 0 for k in SOURCE}
    launched_bf16 = {k: 0 for k in BF16P_KERNELS}
    for dtype in ("bfloat16", "float32"):
        mc = dataclasses.replace(tcfg.model, dtype=dtype)
        b16, f32 = bf16p_models(mc, tree, dev)
        check({p.dtype for p in b16.parameters()} == {torch.bfloat16},
              "param_bf16: the bf16 model has other parameter dtypes")
        if dtype == "bfloat16":
            xs = bf16p_inputs(b16, corpus, dev)
            line["kernel_max_abs_err"] = bf16p_kernels(b16, corpus, xs)
            line["weight_packs"] = bf16p_weight_packs(b16, f32, xs, corpus,
                                                      smi)
            line["pack_ms"] = bf16p_pack_ms(b16, f32)
            del xs
        ops.reset_launches()
        same = bf16p_paths(b16, f32, tcfg, corpus, reqs)
        for k, v in all_launches().items():
            launched[k] += v
        for k, v in bf16p_launches().items():
            launched_bf16[k] += v
        line[f"bitwise_{dtype}"] = same
        check(all(same.values()), f"param_bf16 (a) at {dtype} compute: "
              f"bf16 and float32 params differ on {same}")
        del b16, f32
    check(all(v > 0 for v in launched.values()),
          f"param_bf16 (a): a kernel was not launched: {launched}")
    line["launches_a"] = dict(launched)

    # (c) training at bf16 params, the preset's compute dtype
    mc = dataclasses.replace(tcfg.model, param_dtype="bfloat16")
    model = load_flax_params(CaptionModel(mc, device=dev), tree)
    state = create_train_state(model, make_optimizer(tcfg.train, 1),
                               seed=tcfg.train.seed)
    ref = create_train_state(
        load_flax_params(CaptionModel(tcfg.model, device=dev), tree),
        make_optimizer(tcfg.train, 1), seed=tcfg.train.seed)
    ops.reset_launches()
    step = make_xe_step(model, tcfg.train.label_smoothing, guard=True)
    xe_losses = []
    for i in range(BF16P_XE_STEPS):
        state, m = step(state, *xe_batch(tcfg, corpus, i, dev))
        check(m["nonfinite"] == 0.0 and np.isfinite(m["loss"]),
              f"param_bf16 (c): XE step {i} {m}")
        xe_losses.append(m["loss"])
    rl = tcfg.rl
    trainer = SCSTTrainer(model, RewardComputer(
        corpus["vocab"], corpus["gts"], cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads), rl, guard=True)
    rl_state = create_train_state(
        model, make_optimizer(tcfg.train, 1, lr_override=rl.lr),
        seed=tcfg.train.seed)
    rl_state, cm = trainer.train_step(rl_state, corpus["feats"],
                                      corpus["masks"], corpus["vids"],
                                      seed=100)
    check(cm["nonfinite"] == 0.0 and np.isfinite(cm["rl_loss"]),
          f"param_bf16 (c): CST step {cm}")
    for k, v in all_launches().items():
        launched[k] += v
    for k, v in bf16p_launches().items():
        launched_bf16[k] += v
    check(all(v > 0 for v in launched_bf16.values()),
          f"param_bf16: a kernel never ran on a bf16 pack: {launched_bf16}")
    for st in (state, rl_state):
        kinds = {t.dtype for t in st.params + st.opt_state["mu"]
                 + st.opt_state["nu"]}
        check(kinds == {torch.bfloat16},
              f"param_bf16 (c): params and moments are {kinds}")
    cpu = {dtype: bf16p_vs_cpu(dataclasses.replace(tcfg.model, dtype=dtype),
                               tree, tcfg, corpus)
           for dtype in ("float32", "bfloat16")}
    for dtype, c in cpu.items():
        check(c["ok"], f"param_bf16 (c) at {dtype} compute: card vs CPU "
              f"{c['read']}")
        check(c["control_half_batch"]["refused"]
              and c["control_scaled_1.05"]["refused"],
              f"param_bf16 (c) at {dtype} compute: a control passed the "
              f"card-vs-CPU gate {c}")

    # (d) bytes and the checkpoint round trip
    nb, nf = bf16p_bytes(rl_state), bf16p_bytes(ref)
    check(2 * nb == nf, f"param_bf16 (d): bytes {nb} bf16 vs {nf} float32")
    root = tempfile.mkdtemp(prefix="chip_smoke_bf16p_")
    try:
        save_state(root, "bf16", rl_state)
        save_state(root, "f32", ref)
        fresh = create_train_state(
            load_flax_params(CaptionModel(mc, device=dev),
                             random_flax_params(mc, seed=1)),
            make_optimizer(tcfg.train, 1), seed=0)
        back, _ = load_state(root, "bf16", fresh)
        ok = all(bf16p_equal(a, b) for a, b in zip(
            rl_state.params + rl_state.opt_state["mu"]
            + rl_state.opt_state["nu"],
            back.params + back.opt_state["mu"] + back.opt_state["nu"]))
        check(ok and back.step == rl_state.step,
              "param_bf16 (d): the bf16 checkpoint did not round-trip")
        size = {k: os.path.getsize(os.path.join(root, k, "state.npz"))
                for k in ("bf16", "f32")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line.update(
        launches=launched, bf16_pack_launches=launched_bf16,
        xe_losses=xe_losses, cst_rl_loss=cm["rl_loss"],
        cst_grad_norm=cm["grad_norm"], xe_vs_cpu=cpu,
        param_moment_bytes={"bfloat16": nb, "float32": nf},
        ckpt_bytes=size, ckpt_round_trip_bitwise=ok,
        phase_s=time.perf_counter() - t0, nvidia_smi=smi)
    return line, launched


PHASES = ("data_parallel", "seq_parallel", "model_parallel", "scst", "syncs",
          "serve_composite", "param_bf16")


def run_phases(phases: list[str], smi: str) -> int:
    """``--phases``: the named phases alone (module docstring), each check
    recorded instead of raised; ``NAME:N`` runs the phase N times, each in
    a process of its own -> 1 if a check failed, 2 for an unknown
    phase."""
    global check
    if not phases or any(p.partition(":")[0] not in PHASES for p in phases):
        print(f"chip_smoke: --phases takes {PHASES}", file=sys.stderr)
        return 2
    failed: list[str] = []

    def record(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg[:2000])

    check = record
    dev = torch.device("cuda")
    build.build()
    root = tempfile.mkdtemp(prefix="chip_smoke_phases_")
    data = start = None
    try:
        for phase in phases:
            name, _, n = phase.partition(":")
            before = len(failed)
            if n:
                for _ in range(int(n)):
                    rc = subprocess.call([sys.executable,
                                          os.path.abspath(__file__),
                                          "--phases", name])
                    record(rc == 0, f"{name}: a run exited {rc}")
            elif name == "scst":
                corpus = train_corpus(train_config(), dev)
                scfg, _, trainer, state = scst_setup(corpus, dev)
                emit(scst_line(scfg, scst_phase(scfg, corpus, trainer,
                                                state), smi))
            elif name == "syncs":
                model = make_model(dev)
                tcfg = train_config()
                corpus = train_corpus(tcfg, dev)
                tmodel = train_model(tcfg, corpus, dev)
                scfg, smodel, trainer, _ = scst_setup(corpus, dev)
                emit(syncs_phase(model, requests(model.cfg), tcfg, corpus,
                                 tmodel, trainer, smodel, scfg, smi))
            elif name == "param_bf16":
                tcfg = train_config()
                emit(param_bf16_phase(tcfg, train_corpus(tcfg, dev),
                                      requests(tcfg.model), smi)[0])
            elif name == "serve_composite":
                model = make_model(dev)
                reqs = requests(model.cfg)
                decode_attention(model, smi)
                service(model).serve(reqs[:4])
                kernel_rep, _ = serve_timed(service(model), reqs)
                emit(serve_composite_phase(reqs, kernel_rep, smi)[0])
                del model
            elif name == "data_parallel":
                line, _, data, start = data_parallel_phase(root, smi)
                emit(line)
            else:
                if data is None:
                    data, start, _ = dp_start(root)
                run = (seq_parallel_phase if name == "seq_parallel"
                       else model_parallel_phase)
                emit(run(root, data, start, smi)[0])
            emit({"gates": phase, "failed": failed[before:]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 1 if failed else 0


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_query("name,power.limit")
    name = torch.cuda.get_device_name(0)
    if argv[:1] == ["--phases"]:
        rc = run_phases(argv[1].split(",") if argv[1:] else [], smi)
        print(smi, flush=True)
        if rc == 0:
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": name,
                "count": torch.cuda.device_count()}})
        return rc
    t = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t
    ptxas = [ln.strip() for log in build.build_logs.values()
             for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    # ---- phase 2: every kernel against its plain version --------------------
    model = make_model(dev)
    cfg = model.cfg
    tcfg = train_config()
    corpus = train_corpus(tcfg, dev)
    tmodel = train_model(tcfg, corpus, dev)
    kernels = {k: {"max_abs_err": 0.0} for k in SOURCE}

    def record(kname, res):
        kernels[kname]["max_abs_err"] = max(kernels[kname]["max_abs_err"],
                                            res["max_abs_err"])

    timed = {}
    for kname in KERNELS:
        for bf16 in (False, True):
            x = stride_inputs(model, dev, bf16)
            res = compare(kname, model, x)
            emit({"phase": "kernel_check", "kernel": kname,
                  "bank_dtype": "bfloat16" if bf16 else "float32", **res})
            record(kname, res)
        timed[kname] = x    # the serving dtype: bfloat16 pools
    # the SCST decode's stride: lane 0 greedy + 1 rollout over 64 clips
    scst_x = stride_inputs(model, dev, True, seed=6, B=TRAIN_B, K=1)
    res = compare("fused_decode_stride", model, scst_x)
    emit({"phase": "kernel_check", "kernel": "fused_decode_stride",
          "shape": "scst_g2_b64", "bank_dtype": "bfloat16", **res})
    record("fused_decode_stride", res)
    att, err = check_attention(tmodel, corpus, tcfg)
    record("fused_additive_attention", {"max_abs_err": err})
    for bf16, G in ((False, None), (True, 1), (True, None)):
        x = step_inputs(tmodel, corpus, bf16, G=G)
        res = compare_step(tmodel, x)
        emit({"phase": "kernel_check", "kernel": "fused_decode_step",
              "lanes": x["token"].shape[0], "rows": x["token"].shape[1],
              "bank_dtype": "bfloat16" if bf16 else "float32", **res})
        record("fused_decode_step", res)
        if G == 1:
            step_x1 = x                 # greedy decoding's shape
    step_x = x                          # the rollout's bank: bfloat16
    # the beam step at the eval's shapes (W=5, B=64) on the eval model
    ecfg = eval_config()
    eval_corpus = make_corpus(ecfg.model, EVAL_CLIPS, EVAL_REFS, seed=5)
    t = time.perf_counter()
    emodel, fit_loss = fitted_model(
        ecfg, on_device(eval_corpus, ecfg.model, dev), dev)
    emit({"phase": "model_fit", "for": "eval", "steps": FIT_STEPS,
          "lr": FIT_LR, "last_loss": fit_loss, "s": time.perf_counter() - t})
    for bf16, t, min_len in ((False, 3, 0), (True, 3, 0), (True, 1, 3)):
        x = beam_inputs(emodel, corpus, bf16, t, min_len)
        res = compare_beam(emodel, x)
        emit({"phase": "kernel_check", "kernel": "fused_beam_step",
              "lanes": BEAM_W, "t": t, "min_len": min_len,
              "bank_dtype": "bfloat16" if bf16 else "float32", **res})
        record("fused_beam_step", res)
    beam_x = beam_inputs(emodel, corpus, True, 3, 0)   # the eval's: bf16

    pairs = {k: (lambda k=k: run_kernel(k, model, timed[k]),
                 lambda k=k: run_plain(k, model, timed[k])) for k in KERNELS}
    pairs.update({
        "fused_decode_stride_scst": (
            lambda: run_kernel("fused_decode_stride", model, scst_x),
            lambda: run_plain("fused_decode_stride", model, scst_x)),
        "fused_decode_step": (lambda: run_step_kernel(tmodel, step_x),
                              lambda: run_step_plain(step_x)),
        "fused_decode_step_g1": (lambda: run_step_kernel(tmodel, step_x1),
                                 lambda: run_step_plain(step_x1)),
        "fused_beam_step": (lambda: run_beam_kernel(emodel, beam_x),
                            lambda: run_beam_plain(beam_x)),
    })
    times = time_in_turns(pairs)
    clocks = smi_query("clocks.sm,power.draw")
    bounds = {k: bound_ms(k, model, timed[k], run_kernel(k, model,
                                                         timed[k])[1])
              for k in KERNELS}
    bounds["fused_decode_stride_scst"] = bound_ms(
        "fused_decode_stride", model, scst_x,
        run_kernel("fused_decode_stride", model, scst_x)[1])
    bounds.update(fused_decode_step=step_bound(tmodel, step_x),
                  fused_decode_step_g1=step_bound(tmodel, step_x1),
                  fused_beam_step=beam_bound(emodel, beam_x))
    for key, (ms, plain_ms) in times.items():
        bnd, by = bounds[key]
        emit({"phase": "kernel_time", "kernel": key, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
              "bound_share": bnd / ms,
              "clocks_sm_power_draw": clocks, "nvidia_smi": smi})
    for k in KERNELS + ("fused_decode_step", "fused_beam_step"):
        kernels[k].update(ms=times[k][0], plain_ms=times[k][1],
                          bound_ms=bounds[k][0], bound_by=bounds[k][1])
    # the kernels line carries the update's shape for the attention kernel
    # and the XE step's and M=1000 beside it
    att_t = time_attention(att, smi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, label in ATT_SHAPES.items():
        q, _, mem = att[label, torch.bfloat16][:3]
        att_t[k]["n_e"], att_t[k]["passes"] = attention_ops.attention_split(
            q.shape[0], mem.shape[2], mem.element_size(), sms)
    kernels["fused_additive_attention"].update(
        att_t["b320"], b64=att_t["b64"], m1000=att_t["m1000"],
        decode_b32=decode_attention(model, smi))
    for key, x in (("fused_decode_stride_paged", timed[KERNELS[1]]),
                   ("fused_decode_stride_scst", scst_x)):
        emit({"phase": "stride_phases", "kernel": key,
              **stride_phases(key, model, x), "nvidia_smi": smi})
    L, eL = tmodel.cfg.num_layers, emodel.cfg.num_layers
    phases = {
        "fused_decode_step": step_phases(
            lambda: run_step_kernel(tmodel, step_x), L, beam=False),
        "fused_decode_step_g1": step_phases(
            lambda: run_step_kernel(tmodel, step_x1), L, beam=False),
        "fused_beam_step": step_phases(
            lambda: run_beam_kernel(emodel, beam_x), eL, beam=True)}
    for key, ph in phases.items():
        emit({"phase": "step_phases", "kernel": key, "device_ms": ph,
              "event_ms": times[key][0], "nvidia_smi": smi})
    for k in ("fused_decode_step", "fused_beam_step"):
        kernels[k].update(device_ms=phases[k]["total"],
                          device_phases_ms=phases[k])
    kernels["fused_decode_step"]["g1"] = {
        "ms": times["fused_decode_step_g1"][0],
        "plain_ms": times["fused_decode_step_g1"][1],
        "bound_ms": bounds["fused_decode_step_g1"][0],
        "bound_by": bounds["fused_decode_step_g1"][1],
        "device_ms": phases["fused_decode_step_g1"]["total"]}
    del att, step_x, step_x1, beam_x, scst_x, pairs

    draws, mism = noise_mismatches(dev)
    emit({"phase": "noise", "draws": draws, "cpu_gpu_mismatches": mism})

    # ---- phase 3: serving ---------------------------------------------------
    reqs = requests(cfg)
    # warm-up: first-call costs (allocator, cuBLAS handles) stay out of
    # the timed serve
    service(model).serve(reqs[:4])
    svc = service(model)
    ops.reset_launches()
    rep, wall = serve_timed(svc, reqs)
    dense_rep, dense_wall = serve_timed(service(model, paged=False), reqs)
    serve_launches = {"fused_decode_stride_paged":
                      fused_decode_stride_paged.launches,
                      "fused_decode_stride": fused_decode_stride.launches}
    check_results(rep, cfg)
    check(serve_launches["fused_decode_stride_paged"] == rep.strides,
          f"paged launches {serve_launches} != strides {rep.strides}")
    check(serve_launches["fused_decode_stride"] == dense_rep.strides,
          f"dense launches {serve_launches} != strides {dense_rep.strides}")
    check(launches() == {"fused_additive_attention": 0,
                         "fused_decode_step": 0},
          f"the serve launched training kernels: {launches()}")
    for rid, res in rep.results.items():
        check(np.array_equal(res.tokens, dense_rep.results[rid].tokens)
              and np.array_equal(res.logprobs, dense_rep.results[rid].logprobs),
              f"{rid}: paged and dense-gather serving differ")
    with mock.patch.object(engine, "fused_decode_stride_paged", plain_paged):
        plain_rep, plain_wall = serve_timed(service(model), reqs)
    agree = np.mean([np.array_equal(res.tokens, plain_rep.results[r].tokens)
                     for r, res in rep.results.items()])
    check(agree >= AGREE, f"kernel/plain agreement {agree:.3f} < {AGREE}")
    lat = np.array([r.latency_s for r in rep.results.values()])
    gen = int(sum((r.tokens != PAD_ID).sum() for r in rep.results.values()))
    emit({"phase": "serve", "preset": "msrvtt_xe_attention",
          "capacity": CAPACITY, "K": K, "stride": S, "requests": N_REQUESTS,
          "strides": rep.strides, "launches": serve_launches,
          "plain_agreement": float(agree), "wall_s": wall,
          "requests_per_s": N_REQUESTS / wall, "tokens_per_s": gen / wall,
          "generated_tokens": gen, "p50_latency_s": float(np.percentile(lat, 50)),
          "p99_latency_s": float(np.percentile(lat, 99)),
          "dense_wall_s": dense_wall, "plain_wall_s": plain_wall,
          "sample_caption_ids": next(iter(rep.results.values())).caption_ids,
          "nvidia_smi": smi})

    # ---- phase 3b: the serving lifecycle -------------------------------------
    lifecycle, lifecycle_launches = serve_lifecycle_phase(model, reqs, smi)
    emit(lifecycle)

    # ---- phase 3c: the composite serving stride ------------------------------
    composite, composite_launches = serve_composite_phase(reqs, rep, smi)
    emit(composite)

    # ---- phase 4: training --------------------------------------------------
    state = create_train_state(
        tmodel, make_optimizer(tcfg.train, steps_per_epoch=1),
        seed=tcfg.train.seed)
    xe = xe_phase(tcfg, corpus, state)
    emit({"phase": "train_xe", "preset": tcfg.name, "batch": TRAIN_B, **xe,
          "nvidia_smi": smi})
    rl = tcfg.rl
    reward = RewardComputer(
        corpus["vocab"], corpus["gts"], cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads)
    trainer = SCSTTrainer(tmodel, reward, rl, guard=True)
    # the RL phase starts a fresh optimizer at the RL rate
    rl_state = create_train_state(
        tmodel, make_optimizer(tcfg.train, 1, lr_override=rl.lr),
        seed=tcfg.train.seed)
    cst = cst_phase(tcfg, corpus, trainer, rl_state)
    emit({"phase": "train_cst", "preset": tcfg.name, "batch": TRAIN_B,
          "rollouts": rl.num_rollouts, "baseline": rl.baseline, **cst,
          "nvidia_smi": smi})

    # ---- phase 5: beam-5 eval -----------------------------------------------
    ev = eval_phase(ecfg, MemoryDataset(eval_corpus, ecfg.model), emodel)
    emit({"phase": "eval", "preset": ecfg.name, "decode_impl": "pallas",
          **ev, "nvidia_smi": smi})

    # ---- phase 6: greedy-baseline SCST ---------------------------------------
    scfg, smodel, s_trainer, s_state = scst_setup(corpus, dev)
    # the fitted weights, before SCST moves them: the decoupled and online
    # phases start from them
    fit_sd = {k: v.detach().clone() for k, v in smodel.state_dict().items()}
    sc = scst_phase(scfg, corpus, s_trainer, s_state)
    emit(scst_line(scfg, sc, smi))

    # ---- phases 6b, 6c: decoupled and online RL ------------------------------
    host = make_corpus(tcfg.model, TRAIN_B, 5, seed=0)   # the train corpus
    decoupled, decoupled_launches = rl_decoupled_phase(tcfg, host, fit_sd,
                                                       smi)
    emit(decoupled)
    online, online_launches = rl_online_phase(host, fit_sd, smi)
    emit(online)
    del host, fit_sd

    # ---- phase 6d: one-device resilience --------------------------------------
    resil, resil_launches = resilience_phase(model, reqs, smi)
    emit(resil)

    # ---- phase 6e: the health monitor and the fleet merge ------------------
    healthy, health_launches = health_phase(model, reqs, smi)
    emit(healthy)

    # ---- phase 6f: the lint's sync rules held against the card -------------
    emit(syncs_phase(model, reqs, tcfg, corpus, tmodel, s_trainer, smodel,
                     scfg, smi))

    # ---- phase 6g: bfloat16 parameters --------------------------------------
    bf16p, bf16p_launches = param_bf16_phase(tcfg, corpus, reqs, smi)
    emit(bf16p)
    for k, v in bf16p["kernel_max_abs_err"].items():
        record(k, {"max_abs_err": v})
    # kernels 2-5 on the bf16 weight pack: their launches on phase 6g's
    # paths, and each phase-2 shape's times beside the float32 pack's
    for k in BF16P_KERNELS:
        kernels[k]["bf16_pack_launches"] = bf16p["bf16_pack_launches"][k]
        kernels[k]["bf16_pack"] = {
            key: v for key, v in bf16p["weight_packs"].items()
            if key in (k, k + "_scst", k + "_g1")}

    # launches of each kernel on the paths it runs on, each path counted
    # from 0 just before it
    path_launches = {
        "fused_decode_stride_paged":
            serve_launches["fused_decode_stride_paged"],
        "fused_decode_stride": serve_launches["fused_decode_stride"]
        + sc["launches"]["fused_decode_stride"],
        "fused_additive_attention": xe["launches"]["fused_additive_attention"]
        + cst["launches"]["fused_additive_attention"]
        + sc["launches"]["fused_additive_attention"],
        "fused_decode_step": cst["launches"]["fused_decode_step"],
        "fused_beam_step": ev["launches"]["fused_beam_step"]}
    for launched in (lifecycle_launches, composite_launches,
                     decoupled_launches, online_launches, resil_launches,
                     health_launches, bf16p_launches):
        for k, v in launched.items():
            path_launches[k] += v

    # ---- phase 7: profiles --------------------------------------------------
    emit({"phase": "profile", "path": "serve",
          **profile_serve(model, reqs), "nvidia_smi": smi})
    emit({"phase": "profile", "path": "cst_step",
          **profile_cst(trainer, rl_state, corpus), "nvidia_smi": smi})
    emit({"phase": "profile", "path": "beam5_batch",
          **profile_beam(emodel, corpus), "nvidia_smi": smi})

    # ---- phase 8: the recipe through the CLIs, from files -------------------
    del model, tmodel, emodel, smodel, trainer, s_trainer, state, rl_state
    del s_state
    torch.cuda.empty_cache()
    recipe, recipe_launches = recipe_phase(smi)
    emit(recipe)
    for k, v in recipe_launches.items():
        path_launches[k] += v
    record("fused_additive_attention",
           {"max_abs_err": recipe["meanpool_attention_max_abs_err"]})
    imported, import_launches = import_phase(smi)
    emit(imported)
    for k, v in import_launches.items():
        path_launches[k] += v
    observed, obs_launches = obs_phase(smi)
    emit(observed)
    for k, v in obs_launches.items():
        path_launches[k] += v
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        parallel, dp_launches, dp_data, dp_start = data_parallel_phase(
            root, smi)
        emit(parallel)
        split, split_launches = rl_split_phase(root, dp_data, dp_start, smi)
        emit(split)
        elastic, elastic_launches = elastic_phase(root, dp_data, dp_start,
                                                  smi)
        emit(elastic)
        seq, seq_launches = seq_parallel_phase(root, dp_data, dp_start, smi)
        emit(seq)
        mp_line, mp_launches = model_parallel_phase(root, dp_data, dp_start,
                                                    smi)
        emit(mp_line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for launched in (dp_launches, split_launches, elastic_launches,
                     seq_launches, mp_launches):
        for k, v in launched.items():
            path_launches[k] += v

    print(smi, flush=True)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE[k],
         "replaces": REPLACES[k], "launches": path_launches[k],
         "library_ms": None, **v}
        for k, v in kernels.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_child(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
