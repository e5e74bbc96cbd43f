"""Loss functions (float32, mask-aware), as in the JAX package's
``losses/losses.py``.

- :func:`masked_cross_entropy`: token-masked sequence XE normalized by the
  token count; ``weights`` is the WXE per-caption consensus weight.
- :func:`reinforce_loss`: ``-(reward - baseline) * logprob`` over sampled
  tokens, masked and normalized the same way; the advantage is a constant.
- :func:`sequence_log_probs`: per-token logprobs of given sequences.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sequence_log_probs(logits: torch.Tensor,
                       tokens: torch.Tensor) -> torch.Tensor:
    """logits [B, T, V], tokens [B, T] -> per-token logprobs [B, T] (f32)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens.long()[..., None])[..., 0]


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor,
                         weights: torch.Tensor | None = None,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """Masked (optionally consensus-weighted) sequence XE, mean over
    tokens. ``label_smoothing`` mixes the one-hot target with the uniform
    distribution over the V classes, as ``optax.smooth_labels`` does."""
    logits = logits.float()
    mask = mask.float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        V = logits.shape[-1]
        per_tok = ((1.0 - label_smoothing) * nll
                   - (label_smoothing / V) * logp.sum(dim=-1))
    else:
        per_tok = nll
    if weights is not None:
        mask = mask * weights.float()[:, None]
    return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def reinforce_loss(log_probs: torch.Tensor, mask: torch.Tensor,
                   advantage: torch.Tensor) -> torch.Tensor:
    """REINFORCE: -E[advantage * logp], masked, mean over tokens. Gradients
    flow only through ``log_probs``."""
    mask = mask.float()
    adv = advantage.detach().float()[:, None]
    loss = -(adv * log_probs.float() * mask)
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)
