"""The yardstick's arithmetic against shapes counted by hand."""

import math
from types import SimpleNamespace

import pytest

from benchmark import readers, work

MSRVTT = {"vocab_size": 9000, "modalities": [["resnet", 2048], ["c3d", 500]],
          "encoder": "temporal_attention", "d_embed": 512, "d_hidden": 512,
          "d_att": 256, "num_layers": 1, "max_len": 30, "max_frames": 28,
          "dtype": "bfloat16", "param_dtype": "float32"}
H100 = "NVIDIA H100 80GB HBM3"


def test_dims_of_configs():
    d = work.Dims.of(MSRVTT)
    assert (d.V, d.E, d.H, d.A, d.L, d.F, d.M, d.T) == \
        (9000, 512, 512, 256, 1, 28, 56, 30)
    mp = work.Dims.of({**MSRVTT, "encoder": "meanpool",
                       "modalities": [["resnet", 2048]]})
    assert mp.M == 1 and mp.act_bytes == 2 and mp.param_bytes == 4


def test_flops_match_hand_count():
    d = work.Dims.of(MSRVTT)
    enc, tok = work.enc_and_per_tok_flops(d)
    # frame embeddings of both modalities, then the key projection
    assert enc == 2 * 28 * (2048 + 500) * 512 + 2 * 56 * 512 * 256
    # q proj, scores, context, LSTM (x: 1024 -> 2048, h: 512 -> 2048),
    # output projection
    assert tok == (2 * 512 * 256 + 2 * 56 * 256 + 2 * 56 * 512
                   + 2 * 1024 * 2048 + 2 * 512 * 2048 + 2 * 512 * 9000)
    assert work.update_flops(d, 10, 5) == 3 * 10 * (enc + 5 * 30 * tok)
    assert work.xe_flops(d, 7) == 3 * 7 * (enc + 30 * tok)
    # a clip of CST: five sampled lanes of 30 steps and the update (the
    # self-consensus baseline decodes no greedy lane): about 9.86 GFLOP
    per_clip = enc + 5 * 30 * tok + work.update_flops(d, 1, 5)
    assert 9.0e9 < per_clip < 10.5e9


def test_kernel_work_hand_counted():
    d = work.Dims(V=10, E=4, H=3, A=2, L=1, F=2, feat_dims=(5,), M=2, T=4)
    row = 2 * (3 * 2 + 8 * 12 + 3 * 12 + 3 * 10) + 2 * (4 * 2 + 2 * 4) + 30
    ops, nbytes = work.decode_step_work(d, G=2, B=3)
    assert ops == 6 * row
    weights = (3 * 2 + 2 * 2 + 8 * 12 + 3 * 12 + 12 + 3 * 10 + 10) * 4
    bank = 3 * 2 * ((4 + 2) * 2 + 4)
    assert nbytes == weights + bank + 6 * (4 + 12 + 10) * 4
    ops_a, bytes_a = work.attention_work(d, rows=5)
    assert ops_a == 5 * 2 * (4 * 2 + 2 * 4)
    assert bytes_a == 5 * 2 * 2 + 2 * 2 + 5 * 2 * (6 * 2 + 4) + 5 * 4 * 2


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(989e12, 0.0, H100) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 3.35e12, H100) == pytest.approx(1.0)
    assert work.least_seconds(989e9, 3.35e12, H100) == pytest.approx(1.0)
    assert work.peaks("cpu") is None
    with pytest.raises(ValueError):
        work.least_seconds(1.0, 1.0, "cpu")


def _ctx(**session):
    base = dict(steps=4, units=40, window_s=2.0, t_window=(0.0, 10.0),
                spans=[], trace=None, counters={}, trace_counters={},
                capture={})
    base.update(session)
    cell = SimpleNamespace(batch=10)
    return {"session": SimpleNamespace(**base), "cell": cell,
            "dims": work.Dims.of(MSRVTT), "device": H100}


def test_roofline_and_mfu_readers():
    tr = {"window_s": 2.0, "busy_s": 0.5,
          "kernels": {"void step::step_logits": 0.004,
                      "void step::step_cell": 0.006, "other": 1.0}}
    ctx = _ctx(trace=tr, trace_counters={"k": 2})
    pct = readers.roofline_pct(ctx, ("step_logits", "step_cell"), "k",
                               lambda c: (989e9, 0.0))
    # 2 launches of 1 ms each at the bound, in 10 ms of kernel time
    assert pct == pytest.approx(20.0)
    assert readers.roofline_pct(ctx, ("absent",), "k",
                                lambda c: (1.0, 1.0)) is None
    assert readers.idle_pct(ctx) == pytest.approx(75.0)
    assert readers.mfu_pct(ctx, 989e12) == pytest.approx(50.0)
    assert readers.mfu_pct({**ctx, "device": "cpu"}, 1.0) is None


def test_span_reader_counts_main_thread_spans_in_window():
    spans = [("rl.decode", 1.0, 1.5, "MainThread"),
             ("rl.decode", 2.0, 2.25, "MainThread"),
             ("rl.decode", 2.0, 9.0, "rl-score_0"),
             ("rl.decode", 11.0, 12.0, "MainThread")]
    ctx = _ctx(spans=spans, steps=3)
    assert readers.span_ms(ctx, "rl.decode") == pytest.approx(750 / 3)
    assert readers.span_ms(ctx, "rl.update") is None
    assert math.isclose(readers.span_ms(_ctx(spans=spans, steps=1),
                                        "rl.decode"), 750.0)
