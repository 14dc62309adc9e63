"""Faults planted in the program's timed path, to show that the comparison
that decides ``correct`` catches them (``tests/test_bench_faults.py`` at a
tiny size on the CPU; ``control.py --fault`` at a cell's size on the card).
Each ``plant`` returns the function that takes it out again."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def _patch(owner, name: str, value) -> Callable[[], None]:
    old = getattr(owner, name)
    setattr(owner, name, value)
    return lambda: setattr(owner, name, old)


def unchanged_state():
    """The optimizer's step returns the state unchanged."""
    from transformer_transducer_tpu_torch.training import optim
    return _patch(optim.Optimizer, "step", lambda self, grads: None)


def half_batch():
    """The train step runs on half of the batch's rows, the mean taken
    over them."""
    from transformer_transducer_tpu_torch.training import train_step
    make = train_step.make_train_step

    def make_half(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(batch, gen):
            rows = batch["targets"].shape[0] // 2
            return step({k: v[:rows] for k, v in batch.items()}, gen)
        return half
    return _patch(train_step, "make_train_step", make_half)


def token_altered():
    """Each row's first served token is replaced by the next id."""
    from transformer_transducer_tpu_torch.decoding import greedy
    decode = greedy.greedy_decode

    def altered(model, *args, **kwargs):
        tokens, counts = decode(model, *args, **kwargs)
        tokens = tokens.clone()
        tokens[:, 1] = tokens[:, 1] % (model.vocab_size - 1) + 1
        return tokens, torch.clamp(counts, min=2)
    return _patch(greedy, "greedy_decode", altered)


def half_left_out():
    """The greedy loop decodes half of the batch; the other half gets no
    tokens."""
    from transformer_transducer_tpu_torch.decoding import greedy
    decode = greedy.greedy_decode

    def half(model, enc, t_len, *args, **kwargs):
        rows = enc.shape[0] // 2
        tokens, counts = decode(model, enc[:rows], t_len[:rows], *args, **kwargs)
        rest = enc.shape[0] - rows
        return (torch.cat([tokens, tokens.new_zeros(rest, tokens.shape[1])]),
                torch.cat([counts, counts.new_ones(rest)]))
    return _patch(greedy, "greedy_decode", half)


# the faults each entry kind can have
FAULTS: Dict[str, Tuple[Callable, ...]] = {
    "train": (unchanged_state, half_batch),
    "recognize": (token_altered, half_left_out),
}
