"""The port's serving slice (cst_captioning_tpu_torch.serving) on the CPU.

The slice pin: six ragged requests through the JAX CaptionService with
decode_impl="pallas" (the stride kernel in Pallas interpret mode) and
through the port's CaptionService(device="cpu") with the JAX service's own
Gumbel draws fed in via ``noise_fn``: every lane's tokens equal, logprobs
within 2e-5 (float32), the same NPAD lane. Then the port's own invariants:
a request served mid-flight equals the same request served alone, bit for
bit, and the dense-gather stride equals the paged one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import EOS_ID, ModelConfig
from cst_captioning_tpu.decoding.common import gumbel_step_noise
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.serving import CaptionService as JaxCaptionService
from cst_captioning_tpu.serving import ClipRequest as JaxClipRequest
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.data import Vocab
from cst_captioning_tpu_torch.decoding import counter_gumbel_noise
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.ops import decode_stride
from cst_captioning_tpu_torch.serving import (
    CaptionService,
    ClipRequest,
    OutOfPages,
    PageBank,
    TrafficSpec,
    make_trace,
    synth_request_features,
)

torch.set_num_threads(1)

MODAL = (("resnet", 16),)
T = 12
MAX_F = 8
V = 97
TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=16,
              d_att=8, encoder="temporal_attention", dropout=0.0, max_len=T,
              max_frames=MAX_F, dtype="float32", decode_impl="pallas",
              decode_stride=4)
    jmodel = CaptionModel(ModelConfig(**kw))
    rng = np.random.default_rng(0)
    params = jmodel.init(
        jax.random.key(0),
        {"resnet": jnp.asarray(rng.normal(size=(1, MAX_F, 16)), jnp.float32)},
        {"resnet": jnp.ones((1, MAX_F), jnp.float32)},
        jnp.zeros((1, T), jnp.int32),
    )
    # EOS-biased so caption lengths vary (the continuous-batching regime)
    bias = params["params"]["cell"]["out_proj"]["bias"]
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(2.0)
    tmodel = load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**kw), device="cpu"),
        jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _requests(frames=(1, 8, 3, 8, 2, 5), seed0=1000, cls=ClipRequest):
    out = []
    for i, F in enumerate(frames):
        rng = np.random.default_rng(100 + i)
        out.append(cls(
            req_id=f"r{i}",
            feats={"resnet": rng.normal(size=(F, 16)).astype(np.float32)},
            masks={"resnet": np.ones((F,), np.float32)},
            seed=seed0 + i,
        ))
    return out


@jax.jit
def _jax_row_noise(seed, ts):
    """The JAX service's per-request draws: gumbel(fold_in(fold_in(
    key(seed), k), t), (1, V)) for local steps ts [S] -> [S, K, V]."""
    key = jax.random.key(seed)
    ks = jax.vmap(lambda k: jax.random.fold_in(key, k))(jnp.arange(2))

    def step(t):
        ks_t = jax.vmap(lambda kk: jax.random.fold_in(kk, t))(ks)
        return gumbel_step_noise(ks_t, (1, V), jnp.float32)[:, 0]

    return jax.vmap(step)(ts)


def jax_noise(seeds, ts, K, v):
    assert K == 2 and v == V
    rows = [np.asarray(_jax_row_noise(jnp.int32(s), jnp.asarray(ts[:, b],
                                                                jnp.int32)))
            for b, s in enumerate(seeds.tolist())]
    return torch.from_numpy(np.stack(rows, axis=2))


def _service(tmodel, **kw):
    base = dict(capacity=2, num_rollouts=2, stride=4, frame_bucket=2,
                device="cpu")
    return CaptionService(tmodel, **{**base, **kw})


def test_page_bank_alloc_free_accounting():
    bank = PageBank(num_pages=6, page_size=4)
    p1 = bank.alloc("a", 9)     # ceil(9/4) = 3 pages
    assert len(p1) == 3 and bank.pages_in_use == 3
    assert 0 not in p1          # page 0 is the reserved zero page
    p2 = bank.alloc("b", 4)
    assert len(p2) == 1 and bank.pages_in_use == 4
    with pytest.raises(OutOfPages):
        bank.alloc("c", 12)     # 3 pages needed, 2 free
    with pytest.raises(ValueError, match="already holds"):
        bank.alloc("a", 4)
    table = bank.table(["a", "b", None], width=3)
    assert table.shape == (3, 3)
    np.testing.assert_array_equal(table[0], p1)
    assert table[1, 0] == p2[0] and (table[1, 1:] == 0).all()
    assert (table[2] == 0).all()
    bank.free("a")
    assert bank.pages_in_use == 1 and bank.free_pages == 5
    assert bank.alloc("c", 12) and bank.pages_in_use == 4
    snap = bank.snapshot()
    assert snap["page_size"] == 4 and set(snap["owned"]) == {"b", "c"}
    # the device table and the scatter: pages land where the table says
    bank.init_rows(2, 3)
    bank.bind_row(1, "c")
    assert bank.row_table[1].tolist() == bank.owned("c")
    assert bank.row_lens.tolist() == [0, 12]
    mem = torch.arange(12 * 2, dtype=torch.float32).reshape(1, 12, 2)
    bank.store(bank.owned("c"), mem, mem[..., :1], torch.ones(1, 12))
    pages = bank.owned("c")
    np.testing.assert_array_equal(
        bank.mem[pages].reshape(12, 2).numpy(), mem[0].numpy())
    assert float(bank.mask[0].abs().sum()) == 0.0
    bank.clear_row(1)
    assert bank.row_table.abs().sum() == 0 and bank.row_lens.sum() == 0


def test_serving_matches_jax_pallas_service(setup):
    """The slice pin (module docstring): capacity 2 << 6 ragged requests,
    so most requests take lanes freed mid-flight."""
    jmodel, params, tmodel = setup
    jrep = JaxCaptionService(
        jmodel, params, capacity=2, num_rollouts=2, stride=4, frame_bucket=2,
    ).serve(_requests(cls=JaxClipRequest))
    svc = _service(tmodel, noise_fn=jax_noise)
    rep = svc.serve(_requests())
    assert rep.completed == 6 and rep.strides > T // 4
    for rid, jres in jrep.results.items():
        res = rep.results[rid]
        np.testing.assert_array_equal(res.tokens, jres.tokens, err_msg=rid)
        np.testing.assert_allclose(res.logprobs, jres.logprobs, rtol=TOL,
                                   atol=TOL, err_msg=rid)
        assert res.best_lane == jres.best_lane
        assert res.caption_ids == jres.caption_ids
    assert svc.bank.pages_in_use == 0 and len(svc._free_slots) == 2


def test_midflight_request_equals_request_alone(setup):
    """Per-request determinism with the port's own counter-based noise:
    each request served among others equals it served alone, bit for bit."""
    _, _, tmodel = setup
    reqs = _requests(seed0=2000)
    rep = _service(tmodel).serve(reqs)
    for req in reqs:
        alone = _service(tmodel).serve([req]).results[req.req_id]
        res = rep.results[req.req_id]
        np.testing.assert_array_equal(res.tokens, alone.tokens)
        np.testing.assert_array_equal(res.logprobs, alone.logprobs)
    lens = [(r.tokens != 0).sum() for r in rep.results.values()]
    assert min(lens) < max(lens)   # captions of several lengths


def test_dense_gather_equals_paged(setup):
    _, _, tmodel = setup
    reqs = _requests(frames=(8, 2, 5, 1), seed0=3000)
    paged = _service(tmodel).serve(reqs)
    dense = _service(tmodel, paged=False).serve(reqs)
    for rid, res in paged.results.items():
        np.testing.assert_array_equal(res.tokens, dense.results[rid].tokens)
        np.testing.assert_array_equal(res.logprobs,
                                      dense.results[rid].logprobs)


def test_staging_fills_pool_past_dense_footprint(setup):
    """A pool larger than one batch's dense footprint fills through
    encode-ahead staging; the dense path refuses that pool."""
    _, _, tmodel = setup
    svc = _service(tmodel, num_rollouts=1, frame_bucket=1, page_size=2,
                   num_pages=20)
    rep = svc.serve(_requests(frames=(8,) * 8, seed0=9000))
    assert rep.completed == 8
    assert svc.bank.pages_hwm > svc.B * svc.table_width
    assert svc.bank.pages_in_use == 0
    with pytest.raises(ValueError, match="dense-bank footprint"):
        _service(tmodel, num_rollouts=1, frame_bucket=1, page_size=2,
                 num_pages=20, paged=False)


def test_trace_requests_and_captions(setup):
    """Trace-driven requests complete with captions from the vocab, the
    NPAD lane scores at least the greedy lane, and the CPU path launches
    no kernel."""
    _, _, tmodel = setup
    trace = make_trace(TrafficSpec(num_requests=5, frame_choices=(1, 4, 8)))
    reqs = []
    for item in trace.items:
        feats, masks = synth_request_features(item, MODAL)
        reqs.append(ClipRequest(item.req_id, feats, masks, seed=item.seed))
    vocab = Vocab.from_corpus_words(f"w{i}" for i in range(V - 4))
    decode_stride.reset_launches()
    rep = _service(tmodel, vocab=vocab, capacity=3).serve(reqs)
    assert rep.completed == 5
    assert decode_stride.fused_decode_stride_paged.launches == 0
    for res in rep.results.values():
        sums = res.logprobs.sum(axis=-1)
        assert sums[res.best_lane] >= sums[0]
        assert res.caption == " ".join(f"w{i - 4}" for i in res.caption_ids)


def test_realtime_serve_honors_arrivals(setup):
    """realtime=True admits each request at its arrival time; the decode
    itself does not depend on when a request arrived."""
    _, _, tmodel = setup
    frames = (2, 8, 3)
    reqs = [dataclasses.replace(r, arrival_s=0.03 * i)
            for i, r in enumerate(_requests(frames=frames, seed0=5000))]
    rep = _service(tmodel).serve(reqs, realtime=True)
    assert rep.completed == 3 and rep.wall_s >= reqs[-1].arrival_s
    offline = _service(tmodel).serve(_requests(frames=frames, seed0=5000))
    for req in reqs:
        res = rep.results[req.req_id]
        assert 0.0 <= res.latency_s <= rep.wall_s - req.arrival_s + 1e-6
        assert res.phases["queue_wait"] >= 0.0
        np.testing.assert_array_equal(res.tokens,
                                      offline.results[req.req_id].tokens)


def test_counter_noise_is_a_function_of_its_counters():
    seeds = torch.tensor([7, 7, 8])
    ts = torch.tensor([[0, 0, 0], [1, 1, 1]])
    n = counter_gumbel_noise(seeds, ts, 2, 50)
    assert n.shape == (2, 2, 3, 50) and n.dtype == torch.float32
    assert torch.equal(n[:, :, 0], n[:, :, 1])          # same seed, same t
    assert not torch.equal(n[:, :, 0], n[:, :, 2])      # other seed
    assert not torch.equal(n[0], n[1])                  # other step
    assert not torch.equal(n[:, 0], n[:, 1])            # other lane
    big = counter_gumbel_noise(torch.arange(64), torch.zeros(1, 64,
                                                              dtype=torch.long),
                               1, 1000).double()
    # standard Gumbel: mean 0.5772, variance pi^2 / 6
    assert abs(big.mean().item() - 0.5772) < 0.02
    assert abs(big.var().item() - np.pi ** 2 / 6) < 0.05


def test_service_validation(setup):
    _, _, tmodel = setup
    xla = TorchCaptionModel(dataclasses.replace(tmodel.cfg,
                                                decode_impl="xla"),
                            device="cpu")
    with pytest.raises(ValueError, match="paged=True needs "
                                         "decode_impl='pallas'"):
        CaptionService(xla, paged=True, device="cpu")
    # the stride kernel refuses these; the composite stride serves them
    # (tests/test_torch_serving_composite.py)
    with pytest.raises(ValueError, match="min_len"):
        _service(tmodel, min_len=2)
    with pytest.raises(ValueError, match="num_rollouts"):
        _service(tmodel, num_rollouts=0)
    svc = _service(tmodel)
    with pytest.raises(ValueError, match="frames"):
        svc.submit(_requests(frames=(MAX_F + 1,))[0])
    with pytest.raises(OutOfPages, match="whole pool"):
        _service(tmodel, page_size=2, num_pages=2).serve(
            _requests(frames=(8,)))
