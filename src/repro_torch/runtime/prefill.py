"""Bucketed prefill (the part of the reference's `runtime/prefill.py` that
`generate()` runs): prompts are right-padded to a small geometric ladder of
length buckets. PyTorch runs eagerly, so there is no compile cache; the
bucket still fixes the prefill shapes a server sees, which is what a later
CUDA-graph capture will key on. The packed, protected admission prefill
belongs to continuous serving (next slice).

Right-padding is a dense-family property: causal attention keeps pad
columns out of every real position, the last hidden state is gathered at
each row's true end (`lm_prefill(lengths=...)`), and decode overwrites
cache slot `pos` before attending it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256)


def make_buckets(max_prompt: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Geometric (power-of-two) bucket ladder covering `max_prompt`."""
    out = [b := max(int(min_bucket), 1)]
    while b < max_prompt:
        b *= 2
        out.append(b)
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= length, or None (overflow -> exact-shape path)."""
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    return None


class BucketedPrefill:
    """Pads a prompt batch to its bucket and runs the model's prefill."""

    buckets = DEFAULT_BUCKETS

    def __init__(self, model):
        self.model = model

    @property
    def supported(self) -> bool:
        """Padding is invisible only without ring-buffer window caches
        (`build_model` admits nothing but the dense family)."""
        return not self.model.cfg.window_size

    def usable_buckets(self, max_len: int) -> Tuple[int, ...]:
        """Buckets the cache can hold (prefill writes `bucket` positions
        into a max_len-deep cache)."""
        return tuple(b for b in self.buckets if b <= max_len)

    def prefill_padded(self, params, tokens: torch.Tensor, max_len: int):
        """Pad to the bucket boundary, prefill, return (logits, cache) in the
        model's layout; None when the prompt overflows the ladder."""
        B, S = tokens.shape
        bucket = bucket_for(S, self.usable_buckets(max_len))
        if bucket is None:
            return None
        toks = F.pad(tokens, (0, bucket - S)) if bucket > S else tokens
        lengths = torch.full((B,), S, dtype=torch.int64, device=tokens.device)
        return self.model.prefill(params, {"tokens": toks, "lengths": lengths},
                                  max_len)
