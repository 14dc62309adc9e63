"""SpecAugment-style batch masking (port of ``ops/specaug.py``).

The reference zeroes 10 random time stripes (width U[0,5)) and 10 random
frequency stripes per *batch* inside the training step (reference
``tt/utils.py:297-329``, applied at ``train.py:41-44``): one stripe set for
the whole batch, frequency first, then time.  Widths are ``floor(U[0, max))``
and starts an inclusive ``randint`` (a stripe may end flush at the edge).

The stripes are drawn from an explicit ``torch.Generator`` on the CPU, so a
run is reproducible on any device; the mask is then applied where the
inputs live.  The JAX package draws from ``jax.random``, so the two give
different stripes for the same seed.
"""

from __future__ import annotations

import torch


def _stripe_mask(gen: torch.Generator, length: int, max_width: int,
                 num: int) -> torch.Tensor:
    """Boolean (length,) mask with ``num`` random stripes of width U[0,max)."""
    widths = (torch.rand(num, generator=gen) * max_width).long()
    upper = torch.clamp(length - widths + 1, min=1)
    starts = (torch.rand(num, generator=gen) * upper).long()
    pos = torch.arange(length)[None, :]
    in_stripe = (pos >= starts[:, None]) & (pos < (starts + widths)[:, None])
    return in_stripe.any(dim=0)


def time_mask(gen: torch.Generator, inputs: torch.Tensor,
              max_mask_time: int = 5, mask_num: int = 10) -> torch.Tensor:
    """(B, T, F): zero ``mask_num`` shared time stripes."""
    mask = _stripe_mask(gen, inputs.shape[1], max_mask_time, mask_num)
    return inputs.masked_fill(mask.to(inputs.device)[None, :, None], 0.0)


def frequency_mask(gen: torch.Generator, inputs: torch.Tensor,
                   max_mask_frequency: int = 5, mask_num: int = 10) -> torch.Tensor:
    """(B, T, F): zero ``mask_num`` shared frequency stripes."""
    mask = _stripe_mask(gen, inputs.shape[2], max_mask_frequency, mask_num)
    return inputs.masked_fill(mask.to(inputs.device)[None, None, :], 0.0)


def spec_augment(gen: torch.Generator, inputs: torch.Tensor,
                 max_mask_time: int = 5, max_mask_frequency: int = 5,
                 mask_num: int = 10) -> torch.Tensor:
    """Frequency masking then time masking, as in the reference train step."""
    return time_mask(gen, frequency_mask(gen, inputs, max_mask_frequency,
                                         mask_num), max_mask_time, mask_num)


def spec_augment_per_utterance(gen: torch.Generator, inputs: torch.Tensor,
                               max_mask_time: int = 5,
                               max_mask_frequency: int = 5,
                               mask_num: int = 10) -> torch.Tensor:
    """Stronger variant: independent stripes for each utterance."""
    return torch.cat([spec_augment(gen, x[None], max_mask_time,
                                   max_mask_frequency, mask_num)
                      for x in inputs], dim=0)
