#!/usr/bin/env python3
"""Espnet-family training entry point on the card (port of the root
``train_esptt.py``).

    python -m transformer_transducer_tpu_torch.apps.train_esptt \\
        [-config configs/espnet_aishell.yaml] [-mode retrain|continue] \\
        [--pruned-range N] [--bf16] [--device cpu] ...

The loop of ``apps/train.py``: the trainer picks the model family from the
config (a ``model.mask`` block is the espnet family); ``--bf16`` trains it
with bfloat16 compute over float32 parameters, and ``--remat`` does not
apply to it (logged), as in the JAX trainer; ``--n_data N`` and
``--zero`` train it data-parallel under ``torchrun``, as ``apps/train.py``
does.  Without a ``-config``/``--config`` argument it trains
``configs/espnet_aishell.yaml``.
"""

from __future__ import annotations

import sys

from transformer_transducer_tpu_torch.apps.train import main as train_main

DEFAULT_CONFIG = "configs/espnet_aishell.yaml"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith(("-config", "--config")) for a in argv):
        argv = ["-config", DEFAULT_CONFIG] + argv
    return train_main(argv)


if __name__ == "__main__":
    main()
