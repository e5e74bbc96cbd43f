"""S-step decode stride with in-kernel token selection: the wrappers, their
plain PyTorch versions, and the CUDA kernel's binding.

:func:`fused_decode_stride` and :func:`fused_decode_stride_paged` keep the
argument contract and shapes of the JAX package's TPU kernels of the same
names (``cst_captioning_tpu/ops/decode_pallas.py``), with the decoder cell
module (``models.decoder.DecoderCell``) in place of its flax parameter tree:

    carry    L x (c, h) [G, B, H]     token, finished  [G, B]
    memory / memory_proj / memory_mask  [B, M, E] / [B, M, A] / [B, M]
      or pools [N+1, P, E] / [N+1, P, A] / [N+1, P] + page_table [B, width]
    noise    [S, K, B, V] float32 Gumbel noise for lanes 1..K (K = G - 1)
    -> (new carry, tokens [S, G, B] int32, logprobs [S, G, B] float32)

Lane 0 takes the untempered argmax, lanes 1..K ``argmax(logits / T +
noise)``; ties go to the lowest token id. Finished rows emit PAD with
logprob 0; rows ``b >= n_active`` do no work and pass their carry through.
Each row attends over its own first ``mem_lens[b]`` slots (clipped to
[1, W]). All arithmetic is float32; the carry is rounded to its dtype only
when written out. ``weights`` takes the cell's packed weights
(:func:`stride_weights`) so a decode or a service packs them once, not
once per stride. The pack keeps the parameters' dtype, float32 or
bfloat16, as the TPU kernels take the cell parameters: the kernel and the
plain version widen each weight to float32 where they read it, so a
bfloat16 pack gives bit for bit what the float32 pack of the same values
gives, and no float32 copy of a bfloat16 decoder is made.

On CUDA tensors the wrappers launch the hand-written kernel
``csrc/decode_stride.cu`` (built by ``ops/build.py``; a bfloat16 pack's
launches from its build as ``decode_stride_bf16``) and count the launch
in their ``launches`` attribute (those on a bfloat16 pack in
``launches_bf16`` too); on CPU tensors they run the plain version.
The kernel is one cooperative launch (a grid whose blocks are all resident
at once, stepping in lockstep); the wrapper allocates its workspace
(:func:`stride_workspace`). Nothing falls back: a CUDA call that cannot
launch, a card that refuses the cooperative launch included, raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import torch

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID

NEG = -1.0e9


# the dtypes a pack may hold (the kernels' weights_bf16 flag), and its
# tensors
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
PACK_FIELDS = ("wq", "bq", "v", "wx", "wh", "bg", "wo", "bo", "embt")


@dataclass(frozen=True)
class StrideWeights:
    """The decoder cell's weights in the kernel's [in, out] layout, all in
    one dtype of :data:`WEIGHT_DTYPES` (the parameters'); a pack that mixes
    dtypes, or holds another, raises."""

    wq: torch.Tensor    # [H, A]
    bq: torch.Tensor    # [A]
    v: torch.Tensor     # [A]
    wx: torch.Tensor    # flat: layer 0 [E + E, 4H], then layers 1.. [H, 4H]
    wh: torch.Tensor    # [L, H, 4H]
    bg: torch.Tensor    # [L, 4H]
    wo: torch.Tensor    # [H, V]
    bo: torch.Tensor    # [V]
    embt: torch.Tensor  # [V, E]
    # (device, widths, dtype) the step wrappers have checked these tensors
    # for (ops/decode_step.step_args), so a decode loop checks them once
    checked: set = field(default_factory=set, init=False, compare=False,
                         repr=False)

    def __post_init__(self):
        kinds = {getattr(self, n).dtype for n in PACK_FIELDS}
        if len(kinds) != 1 or not kinds <= set(WEIGHT_DTYPES):
            raise ValueError(
                f"a stride weight pack holds one dtype of {WEIGHT_DTYPES}; "
                f"got {sorted(str(k) for k in kinds)}")

    @property
    def num_layers(self) -> int:
        return self.wh.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.wq.dtype


def stride_weights(cell) -> StrideWeights:
    """Pack a ``DecoderCell``'s parameters for the stride, in their dtype
    (float32 or bfloat16; the transposes are the only copies)."""
    f = lambda t: t.detach()  # noqa: E731
    att = cell.attention
    return StrideWeights(
        wq=f(att.query_proj.weight).t().contiguous(),
        bq=f(att.query_proj.bias).contiguous(),
        v=f(att.score).contiguous(),
        wx=torch.cat([f(c.weight_i).t().reshape(-1) for c in cell.lstm]),
        wh=torch.stack([f(c.weight_h).t() for c in cell.lstm]).contiguous(),
        bg=torch.stack([f(c.bias) for c in cell.lstm]).contiguous(),
        wo=f(cell.out_proj.weight).t().contiguous(),
        bo=f(cell.out_proj.bias).contiguous(),
        embt=f(cell.word_embed.weight).contiguous(),
    )


# ---- the kernel's workspace --------------------------------------------------

TILE_N = 64      # logits columns of one kernel tile (rowgemm.cuh BN)
SPLIT_K = 256    # k of one split-K slice of q and the gates (kSplitK in the .cu)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stride_workspace(G: int, B: int, E: int, Em: int, A: int, H: int,
                     L: int, V: int) -> dict[str, int]:
    """The kernel's workspace regions in floats, in its order (``carve`` in
    csrc/decode_stride.cu, which checks the total), each rounded up to 4
    floats: per row (R = G * B) and 64-column logits tile the selection
    partials (4 floats and an id), q's and the widest gate GEMM's split-K
    partials, the layer-0 input, the working carry, finished and token."""
    R = G * B
    n_tiles = _cdiv(V, TILE_N)
    ks_q = _cdiv(H, SPLIT_K)
    ks_gates = _cdiv(max(E + Em, H) + H, SPLIT_K)
    sizes = {
        "part": 4 * R * n_tiles, "part_id": R * n_tiles,
        "q": ks_q * R * A, "gates": ks_gates * R * 4 * H,
        "x": R * (E + Em), "h": L * R * H, "c": L * R * H,
        "finished": R, "token": R,
    }
    return {k: _cdiv(n, 4) * 4 for k, n in sizes.items()}


def timeline_len(steps: int, num_layers: int) -> int:
    """Entries of a stride launch's phase timeline: a (code, ns) pair at the
    start, after init and q, after each step's attend, gates and cell (per
    layer) and logits, and at the end."""
    return 2 * (4 + steps * (2 + 2 * num_layers))


# ---- plain versions ----------------------------------------------------------


def gather_pages(mem_pool, proj_pool, mask_pool, table):
    """Dense [B, W, *] bank from page pools + a [B, width] table (page 0 is
    the shared zero page, so table padding gathers masked slots)."""
    B, width = table.shape
    P = mem_pool.shape[1]
    flat = table.reshape(-1).long()
    mem = mem_pool[flat].reshape(B, width * P, -1)
    proj = proj_pool[flat].reshape(B, width * P, -1)
    mask = mask_pool[flat].reshape(B, width * P)
    return mem, proj, mask


def decode_stride_plain(w: StrideWeights, carry, token, finished, memory,
                        memory_proj, memory_mask, noise, t0: int,
                        n_active: int, *, steps: int, temperature: float,
                        min_len: int, mem_lens, return_gap: bool = False):
    """The stride in plain PyTorch, on any device: S chained decode steps
    with the kernel's selection and freezing semantics. ``return_gap``
    also returns each step's gap between the best and second-best selection
    value, [S, G, B], to tell argmax near-ties from real disagreements."""
    G, B = token.shape
    M = memory.shape[1]
    dev = memory.device
    mem = memory.float()
    proj = memory_proj.float()
    lens = mem_lens.to(dev).long().clamp(1, M)
    in_row = torch.arange(M, device=dev)[None, :] < lens[:, None]     # [B, M]
    active = torch.arange(B, device=dev) < n_active
    fin = finished.to(dev).bool() | ~active[None, :]
    cs = [c.float() for c, _ in carry]
    hs = [h.float() for _, h in carry]
    H4 = w.bg.shape[1]
    # the weights widened to float32 as the TPU kernels widen the
    # parameter-dtype weights (the identity on a float32 pack); the
    # embedding rows as they are gathered
    wq, bq, v, wx_all, wh, bg, wo, bo = (t.float() for t in (
        w.wq, w.bq, w.v, w.wx, w.wh, w.bg, w.wo, w.bo))
    emb = w.embt[token.long()].float()
    toks, lps, gaps = [], [], []
    for s in range(steps):
        live = ~fin
        q = hs[-1] @ wq + bq                                          # [G, B, A]
        t = torch.tanh(proj[None] + q[:, :, None, :])
        sc = t @ v                                                    # [G, B, M]
        sc = torch.where(memory_mask[None] > 0, sc, torch.full_like(sc, NEG))
        sc = torch.where(in_row[None], sc, torch.full_like(sc, -torch.inf))
        att = torch.softmax(sc, dim=-1)
        ctx = torch.einsum("gbm,bme->gbe", att, mem)
        x = torch.cat([emb, ctx], dim=-1)
        off = 0
        for layer in range(w.num_layers):
            n_in = x.shape[-1]
            wx = wx_all[off:off + n_in * H4].view(n_in, H4)
            off += n_in * H4
            gates = x @ wx + hs[layer] @ wh[layer] + bg[layer]
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * cs[layer] + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            # a finished row's carry is frozen, as in the kernel
            cs[layer] = torch.where(live[..., None], c_new, cs[layer])
            hs[layer] = torch.where(live[..., None], h_new, hs[layer])
            x = h_new
        logits = x @ wo + bo                                          # [G, B, V]
        logits[..., PAD_ID] = NEG
        logits[..., BOS_ID] = NEG
        if t0 + s < min_len:
            logits[..., EOS_ID] = NEG
        sel = torch.cat([logits[:1], logits[1:] / temperature + noise[s]])
        nxt = torch.argmax(sel, dim=-1)
        if return_gap:
            top2 = torch.topk(sel, 2, dim=-1).values
            gaps.append(top2[..., 0] - top2[..., 1])
        lp = (torch.gather(logits, -1, nxt[..., None])[..., 0]
              - torch.logsumexp(logits, dim=-1))
        nxt = torch.where(fin, torch.full_like(nxt, PAD_ID), nxt)
        lp = torch.where(fin, torch.zeros_like(lp), lp)
        fin = fin | (nxt == EOS_ID)
        emb = w.embt[nxt].float()
        toks.append(nxt.to(torch.int32))
        lps.append(lp)
    new_carry = tuple(
        (c.to(c0.dtype), h.to(h0.dtype))
        for c, h, (c0, h0) in zip(cs, hs, carry)
    )
    out = (new_carry, torch.stack(toks), torch.stack(lps))
    return out + (torch.stack(gaps),) if return_gap else out


# ---- the kernel's binding ----------------------------------------------------


class _StrideArgs(ctypes.Structure):
    """Mirror of ``struct StrideArgs`` in csrc/decode_stride.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "mem", "proj", "mask", "table", "wq", "bq", "v", "wx", "wh", "bg",
        "wo", "bo", "embt", "token", "finished", "mem_lens", "c_in", "h_in",
        "noise", "tokens", "logprobs", "c_out", "h_out",
    )] + [(n, ctypes.c_int) for n in (
        "bank_bf16", "weights_bf16", "slots", "width", "G", "B", "S", "V",
        "E", "Em", "A", "H", "L", "t0", "n_active", "min_len",
    )] + [("temperature", ctypes.c_float), ("ws", ctypes.c_void_p),
          ("ws_floats", ctypes.c_longlong), ("timeline", ctypes.c_void_p)]


@functools.cache
def _lib(bf16: bool = False) -> ctypes.CDLL:
    """The kernel library for float32 or (``bf16``) bfloat16 weights,
    built on first use, with its C signatures."""
    from cst_captioning_tpu_torch.ops import build

    lib = build.load("decode_stride_bf16") if bf16 else \
        build.load("decode_stride")
    for fn in (lib.decode_stride_dense, lib.decode_stride_paged):
        fn.argtypes = [ctypes.POINTER(_StrideArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.decode_stride_workspace_floats.argtypes = [
        ctypes.POINTER(_StrideArgs)]
    lib.decode_stride_workspace_floats.restype = ctypes.c_longlong
    lib.decode_stride_error_string.argtypes = [ctypes.c_int]
    lib.decode_stride_error_string.restype = ctypes.c_char_p
    return lib


def _expect(t: torch.Tensor, name: str, dev, dtypes, shape=None) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(entry: str, w: StrideWeights, carry, token, finished, mem, proj,
            mask, table, slots: int, width: int, noise, t0: int,
            n_active: int, steps: int, temperature: float, min_len: int,
            mem_lens, timeline=None):
    """Launch ``entry``. ``timeline``: None, or an int64 tensor on the
    card of at least ``timeline_len(steps, L)`` zeros, into which block 0
    writes a (phase code, %globaltimer ns) pair as it leaves each grid
    barrier (codes: 0 start, 1 init, 2 q, 3 attend, 4 gates, 5 cell,
    6 logits, 7 end; the phase that ends at the mark)."""
    dev = mem.device
    G, B = token.shape
    L = len(carry)
    H = carry[0][0].shape[-1]
    E = w.embt.shape[1]
    Em = mem.shape[-1]
    A = proj.shape[-1]
    V = w.embt.shape[0]
    if mem.dtype != proj.dtype:
        raise ValueError(f"mem {mem.dtype} and proj {proj.dtype} differ")
    bank_types = (torch.float32, torch.bfloat16)
    _expect(mem, "memory", dev, bank_types)
    _expect(proj, "memory_proj", dev, bank_types)
    _expect(mask, "memory_mask", dev, (torch.float32,))
    if table is not None:
        _expect(table, "page_table", dev, (torch.int32,), (B, width))
    _expect(noise, "noise", dev, (torch.float32,), (steps, G - 1, B, V))
    for name in PACK_FIELDS:
        _expect(getattr(w, name), name, dev, (w.dtype,))
    if w.wx.numel() != (E + Em) * 4 * H + (L - 1) * H * 4 * H:
        raise ValueError("LSTM input weights do not match [E + Em, 4H]")
    if timeline is not None:
        _expect(timeline, "timeline", dev, (torch.int64,))
        if timeline.numel() < timeline_len(steps, L):
            raise ValueError("timeline is shorter than timeline_len")
    tok = token.to(torch.int32).contiguous()
    fin = finished.to(torch.int32).contiguous()
    lens = mem_lens.to(device=dev, dtype=torch.int32).contiguous()
    c_in = torch.stack([c.float() for c, _ in carry]).contiguous()
    h_in = torch.stack([h.float() for _, h in carry]).contiguous()
    for name, t, shape in (("token", tok, (G, B)), ("finished", fin, (G, B)),
                           ("mem_lens", lens, (B,)),
                           ("carry", c_in, (L, G, B, H)),
                           ("carry", h_in, (L, G, B, H))):
        _expect(t, name, dev, (t.dtype,), shape)
    tokens = torch.empty((steps, G, B), dtype=torch.int32, device=dev)
    logprobs = torch.empty((steps, G, B), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(c_in)
    h_out = torch.empty_like(h_in)
    ws = torch.empty(sum(stride_workspace(G, B, E, Em, A, H, L, V).values()),
                     dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = _StrideArgs(
        mem=ptr(mem), proj=ptr(proj), mask=ptr(mask), table=ptr(table),
        wq=ptr(w.wq), bq=ptr(w.bq), v=ptr(w.v), wx=ptr(w.wx), wh=ptr(w.wh),
        bg=ptr(w.bg), wo=ptr(w.wo), bo=ptr(w.bo), embt=ptr(w.embt),
        token=ptr(tok), finished=ptr(fin), mem_lens=ptr(lens),
        c_in=ptr(c_in), h_in=ptr(h_in), noise=ptr(noise),
        tokens=ptr(tokens), logprobs=ptr(logprobs), c_out=ptr(c_out),
        h_out=ptr(h_out),
        bank_bf16=int(mem.dtype == torch.bfloat16),
        weights_bf16=int(w.dtype == torch.bfloat16), slots=slots, width=width,
        G=G, B=B, S=steps, V=V, E=E, Em=Em, A=A, H=H, L=L, t0=int(t0),
        n_active=int(n_active), min_len=int(min_len),
        temperature=float(temperature), ws=ptr(ws), ws_floats=ws.numel(),
        timeline=ptr(timeline),
    )
    lib = _lib(w.dtype == torch.bfloat16)
    # the launch is asynchronous; the temporaries above may be freed on
    # return because the caching allocator reuses their memory only for
    # work queued later on this same stream
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.decode_stride_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} (cudaError {rc})")
    new_carry = tuple(
        (c_out[i].to(c.dtype), h_out[i].to(h.dtype))
        for i, (c, h) in enumerate(carry)
    )
    return new_carry, tokens, logprobs


# ---- the wrappers ------------------------------------------------------------


def _check(cell, carry, token, noise, steps, num_layers, fn_name):
    n = len(cell.lstm)
    if num_layers is not None and num_layers != n:
        raise ValueError(
            f"num_layers {num_layers} does not match the cell's {n} layers"
        )
    if len(carry) != n:
        raise ValueError(f"carry has {len(carry)} layers, the cell {n}")
    G, B = token.shape
    if G < 2:
        raise ValueError(
            f"{fn_name} needs the (1+K)-lane layout with K >= 1 sampled "
            f"lanes; got G={G}"
        )
    if tuple(noise.shape[:3]) != (steps, G - 1, B):
        raise ValueError(
            f"noise shape {tuple(noise.shape)} does not match "
            f"[steps={steps}, K={G - 1}, B={B}, V]"
        )
    return G, B


def _device_of(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def fused_decode_stride(cell, carry, token, finished, memory, memory_proj,
                        memory_mask, noise, t0=0, n_active=None, *,
                        steps: int, temperature: float = 1.0,
                        min_len: int = 0, num_layers: int | None = None,
                        mem_lens=None, weights: StrideWeights | None = None):
    """S decode steps over a dense memory bank (module docstring)."""
    G, B = _check(cell, carry, token, noise, steps, num_layers,
                  "fused_decode_stride")
    M = memory.shape[1]
    if memory.shape[0] != B or memory_mask.shape != (B, M):
        raise ValueError(
            f"memory {tuple(memory.shape)} / mask "
            f"{tuple(memory_mask.shape)} do not match [B={B}, M]"
        )
    n_active = B if n_active is None else int(n_active)
    if mem_lens is None:
        mem_lens = torch.full((B,), M, dtype=torch.int32,
                              device=memory.device)
    w = weights if weights is not None else stride_weights(cell)
    if _device_of(memory).type == "cpu":
        return decode_stride_plain(
            w, carry, token, finished, memory, memory_proj, memory_mask,
            noise, int(t0), n_active, steps=steps, temperature=temperature,
            min_len=min_len, mem_lens=mem_lens,
        )
    out = _launch(
        "decode_stride_dense", w, carry, token, finished, memory,
        memory_proj, memory_mask, None, M, 1, noise, t0, n_active, steps,
        temperature, min_len, mem_lens,
    )
    fused_decode_stride.launches += 1
    fused_decode_stride.launches_bf16 += int(w.dtype == torch.bfloat16)
    return out


def fused_decode_stride_paged(cell, carry, token, finished, mem_pool,
                              proj_pool, mask_pool, page_table, noise, t0=0,
                              n_active=None, *, steps: int,
                              temperature: float = 1.0, min_len: int = 0,
                              num_layers: int | None = None, mem_lens=None,
                              weights: StrideWeights | None = None):
    """:func:`fused_decode_stride` reading the bank through a page table:
    pools ``[N+1, P, *]`` (row 0 the zero page) and ``page_table [B,
    width]``; ``mem_lens`` defaults to every row's full ``width * P``."""
    G, B = _check(cell, carry, token, noise, steps, num_layers,
                  "fused_decode_stride_paged")
    if page_table.ndim != 2 or page_table.shape[0] != B:
        raise ValueError(
            f"page_table shape {tuple(page_table.shape)} does not match "
            f"[B={B}, max_pages]"
        )
    if mem_pool.ndim != 3 or proj_pool.ndim != 3 or mask_pool.ndim != 2:
        raise ValueError(
            "pools must be [N+1, P, E] / [N+1, P, A] / [N+1, P]; got "
            f"{tuple(mem_pool.shape)} / {tuple(proj_pool.shape)} / "
            f"{tuple(mask_pool.shape)}"
        )
    P = mem_pool.shape[1]
    width = page_table.shape[1]
    n_active = B if n_active is None else int(n_active)
    if mem_lens is None:
        mem_lens = torch.full((B,), width * P, dtype=torch.int32,
                              device=mem_pool.device)
    w = weights if weights is not None else stride_weights(cell)
    if _device_of(mem_pool).type == "cpu":
        memory, memory_proj, memory_mask = gather_pages(
            mem_pool, proj_pool, mask_pool, page_table
        )
        return decode_stride_plain(
            w, carry, token, finished, memory, memory_proj, memory_mask,
            noise, int(t0), n_active, steps=steps, temperature=temperature,
            min_len=min_len, mem_lens=mem_lens,
        )
    out = _launch(
        "decode_stride_paged", w, carry, token, finished, mem_pool,
        proj_pool, mask_pool, page_table, P, width, noise, t0, n_active,
        steps, temperature, min_len, mem_lens,
    )
    fused_decode_stride_paged.launches += 1
    fused_decode_stride_paged.launches_bf16 += int(w.dtype == torch.bfloat16)
    return out


fused_decode_stride.launches = fused_decode_stride.launches_bf16 = 0
fused_decode_stride_paged.launches = 0
fused_decode_stride_paged.launches_bf16 = 0


def reset_launches() -> None:
    for fn in (fused_decode_stride, fused_decode_stride_paged):
        fn.launches = fn.launches_bf16 = 0
