"""The device view of a trace: the union of device intervals, the idle
gaps and their labels, on a synthetic chrome trace."""

import pytest

from benchmark import trace


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert trace.union_seconds(iv) == pytest.approx(5.0)
    assert trace.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert trace.gaps([], 0, 1) == [(0, 1)]
    assert trace.union_seconds([]) == 0.0


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_summarize_clips_to_the_window_and_labels_gaps():
    doc = {"traceEvents": [
        _ev(trace.MARK, "user_annotation", 100, 1000),
        _ev("void step::step_logits<false>(float*)", "kernel", 50, 100),
        _ev("void step::step_logits<false>(float*)", "kernel", 300, 100),
        _ev("Memcpy HtoD", "gpu_memcpy", 350, 100),
        _ev("other_kernel", "kernel", 900, 400),
        _ev("aten::item", "cpu_op", 500, 300),
        _ev("aten::copy_", "cpu_op", 550, 100),
    ]}
    s = trace.summarize(doc)
    assert s["window_s"] == pytest.approx(1e-3)
    # [100, 150) + [300, 450) + [900, 1100)
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["kernels"]["step::step_logits"] == pytest.approx(150e-6)
    assert s["kernels"]["other_kernel"] == pytest.approx(200e-6)
    gaps = dict((round(v * 1e6), k) for k, v in s["gaps"])
    # the longest gap, [450, 900), is labelled by the shortest host op
    # covering its middle (675: aten::item); [150, 300) by none
    assert gaps[450] == "aten::item"
    assert gaps[150] == "host"
    assert s["ops"][0][0] == "other_kernel"
    assert trace.kernel_seconds(s, ("step_logits",)) == pytest.approx(150e-6)
    assert trace.kernel_seconds(s, ("absent",)) is None
    assert trace.summarize({"traceEvents": []}) is None


def test_short_name():
    assert trace.short_name("void a::b<int, 3>(float const*, int)") == "a::b"
    assert trace.short_name(
        "void (anonymous namespace)::additive_attention_kernel<__nv_bfloat16>"
        "(AttentionArgs)") == "(anonymous namespace)::additive_attention_kernel"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD"
    assert len(trace.short_name("x" * 100)) == 64
