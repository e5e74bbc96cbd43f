"""The caption model in plain PyTorch, float32 with TF32 off.

The architecture of Phan et al. (arXiv:1712.09532) as the configuration
files state it: per-modality frame embeddings (``tanh``), a temporal
bank of every frame or one mean-pooled slot a modality, additive
attention ``v . tanh(W_m m + W_q h + b)`` with a masked softmax, an
input-feed LSTM (gates ``i|f|g|o``, ``h W_h + b + x W_i``), a carry
initialised from the bank's masked mean, and the output projection.
Dropout (training only) keeps with probability ``1 - rate`` and scales
by ``1 / (1 - rate)``, after the ``[emb, ctx]`` concat and before the
output projection, with masks drawn from the caller's generator.

``quant`` rounds every matmul operand (and the embedding table): the
identity for the reference, ``fp8_round`` for the control, which puts
the reference in the port's place one precision below its bfloat16.
"""

from __future__ import annotations

import torch

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
NEG = -1.0e9


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3, back in float32; the gradient
    passes the rounding unchanged (straight through)."""
    d = x.detach()
    s = 448.0 / d.abs().amax().clamp(min=1e-12)
    q = (d * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return x + (q - d)


def _same(x):
    return x


class RefModel:
    """``weights``: the named leaves (``benchmark.weights``), used as
    given (float32 leaves that require grad, for training); ``model``:
    the configuration's ``model`` section."""

    def __init__(self, model: dict, weights: dict, quant=None):
        self.cfg = model
        self.w = weights
        self.q = quant or _same
        self.mods = [str(n) for n, _ in model["modalities"]]
        self.L = int(model["num_layers"])
        self.rate = float(model["dropout"])

    def lin(self, x, name, bias=True):
        q = self.q
        y = q(x) @ q(self.w[f"{name}.weight"]).T
        return y + self.w[f"{name}.bias"] if bias else y

    def encode(self, feats, masks):
        """-> (memory [B, M, E], proj [B, M, A], mask [B, M], carry)."""
        slots, smasks = [], []
        for m in self.mods:
            f, k = feats[m].float(), masks[m].float()
            if self.cfg["encoder"] == "meanpool":
                pooled = (f * k[..., None]).sum(1) / k.sum(1).clamp(
                    min=1.0)[:, None]
                slots.append(torch.tanh(self.lin(pooled, f"encoder.embed.{m}"))
                             [:, None])
                smasks.append(torch.ones_like(k[:, :1]))
            else:
                slots.append(torch.tanh(self.lin(f, f"encoder.embed.{m}")))
                smasks.append(k)
        memory = torch.cat(slots, 1)
        mask = torch.cat(smasks, 1)
        memory = memory * mask[..., None]
        proj = self.lin(memory, "cell.attention.mem_proj", bias=False)
        ctx0 = (memory * mask[..., None]).sum(1) / mask.sum(1).clamp(
            min=1.0)[:, None]
        carry = tuple((torch.tanh(self.lin(ctx0, f"init_c.{i}")),
                       torch.tanh(self.lin(ctx0, f"init_h.{i}")))
                      for i in range(self.L))
        return memory, proj, mask, carry

    def _drop(self, x, gen):
        if gen is None or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) \
            < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))

    def step(self, carry, token, enc, gen=None):
        """One step -> (carry, logits [rows, V] float32); ``enc`` rows
        match ``token``'s."""
        memory, proj, mask, _ = enc
        q = self.q
        h_top = carry[-1][1]
        qv = self.lin(h_top, "cell.attention.query_proj")
        t = torch.tanh(proj + qv[:, None])
        scores = q(t) @ q(self.w["cell.attention.score"])
        scores = torch.where(mask > 0, scores, torch.full_like(scores, NEG))
        att = torch.softmax(scores, -1)
        ctx = torch.einsum("bm,bme->be", q(att), q(memory))
        emb = q(self.w["cell.word_embed.weight"])[token.long()]
        x = self._drop(torch.cat([emb, ctx], -1), gen)
        out = []
        for i in range(self.L):
            c, h = carry[i]
            g = (q(h) @ q(self.w[f"cell.lstm.{i}.weight_h"]).T
                 + self.w[f"cell.lstm.{i}.bias"]
                 + q(x) @ q(self.w[f"cell.lstm.{i}.weight_i"]).T)
            gi, gf, gg, go = g.chunk(4, -1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            out.append((c, h))
            x = h if i + 1 == self.L else self._drop(h, gen)
        return tuple(out), self.lin(self._drop(x, gen), "cell.out_proj")


def tile(enc, K: int):
    """[B, ...] -> [K*B, ...], rollout-major."""
    memory, proj, mask, carry = enc
    t = lambda x: x.repeat((K,) + (1,) * (x.ndim - 1))  # noqa: E731
    return (t(memory), t(proj), t(mask),
            tuple((t(c), t(h)) for c, h in carry))


def shift_right(labels: torch.Tensor) -> torch.Tensor:
    bos = torch.full_like(labels[:, :1], BOS_ID)
    return torch.cat([bos, labels[:, :-1]], 1)


def teacher_force(model: RefModel, enc, labels, gen=None, each=None):
    """Teacher-forced unroll over ``labels`` [R, T]; ``each(t, logits)``
    sees every step's float32 logits and its values are returned as a
    list."""
    inputs = shift_right(labels)
    carry = enc[3]
    out = []
    for t in range(labels.shape[1]):
        carry, logits = model.step(carry, inputs[:, t], enc, gen)
        out.append(each(t, logits))
    return out


def token_logps(model: RefModel, enc, labels, gen=None) -> torch.Tensor:
    """Per-position logprob of ``labels`` [R, T] -> [R, T]."""
    return torch.stack(teacher_force(
        model, enc, labels, gen,
        lambda t, lg: torch.log_softmax(lg, -1).gather(
            -1, labels[:, t:t + 1].long())[:, 0]), 1)


def forbid_special(logits: torch.Tensor) -> torch.Tensor:
    out = logits.clone()
    out[..., PAD_ID] = NEG
    out[..., BOS_ID] = NEG
    return out


@torch.no_grad()
def sample(model: RefModel, enc, K: int, T: int, temperature: float,
           noise) -> torch.Tensor:
    """K sampled rollouts a clip -> tokens [K, B, T]: each step's token
    the argmax of ``logits / temperature + noise(t)`` (``noise(t)`` [K, B,
    V]), PAD after EOS."""
    B = enc[0].shape[0]
    enc_k = tile(enc, K)
    carry = enc_k[3]
    dev = enc[0].device
    token = torch.full((K * B,), BOS_ID, dtype=torch.int64, device=dev)
    finished = torch.zeros(K * B, dtype=torch.bool, device=dev)
    out = torch.full((K * B, T), PAD_ID, dtype=torch.int64, device=dev)
    for t in range(T):
        carry, logits = model.step(carry, token, enc_k)
        z = forbid_special(logits) / temperature \
            + noise(t).reshape(K * B, -1)
        nxt = torch.where(finished, torch.full_like(token, PAD_ID),
                          z.argmax(-1))
        out[:, t] = nxt
        finished = finished | (nxt == EOS_ID)
        token = nxt
        if bool(finished.all()):
            break
    return out.view(K, B, T)
