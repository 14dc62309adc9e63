#!/usr/bin/env python3
"""Offline single-wav recognition on the card (port of ``apps/predict.py``).

Loads a config + a checkpoint (a port trainer's ``epoch_N`` directory, its
``model.pt``, a flat ``state_dict`` file written with ``torch.save``, or an
``epoch_N`` / ``step_N`` directory the JAX package's ``train.py`` wrote), extracts
features, encodes under the streaming band through the banded kernel (or
full-context through the flash kernel), decodes greedily (or, with
``--beam``, by the width-5 beam search) and reports CER against an
optional reference transcript.  An espnet-schema config (``model.mask``)
serves the espnet family: its encoder bands itself (plain tensor code),
with the utterance's length as its pad mask, so ``--full-context`` does not
apply to it (as in the JAX CLI).  ``--int8`` serves the W8A8 twin of the
model (``ops/quant.py``); an int8-baked checkpoint
(``tools/quantize_checkpoint.py``) is served int8 with or without it.

    python -m transformer_transducer_tpu_torch.apps.predict \\
        --config configs/joint_streaming.yaml \\
        --checkpoint egs/<name>/<save_model>/epoch_19 \\
        --wav path/to/audio.wav [--truth "真实文本"] [--full-context] \\
        [--beam] [--int8]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="a checkpoint directory written by the port's trainer "
                         "(epoch_N), its model.pt, a flat state_dict file "
                         "written with torch.save, or a JAX package checkpoint "
                         "directory (msgpack)")
    ap.add_argument("--wav", required=True)
    ap.add_argument("--truth", default=None)
    ap.add_argument("--beam", action="store_true", help="width-5 beam search")
    ap.add_argument("--int8", action="store_true", help="W8A8 int8 serving")
    ap.add_argument("--full-context", action="store_true",
                    help="no banded mask (offline model)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE", help="config override (dotted key)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run there)")
    args = ap.parse_args(argv)

    from transformer_transducer_tpu_torch.data.wav import read_wave
    from transformer_transducer_tpu_torch.decoding.beam import recognize_beam
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.models.espnet_variant import is_espnet_config
    from transformer_transducer_tpu_torch.models.factory import load_family
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.utils.config import (
        apply_overrides, load_config, stack_context, subsample_factor)
    from transformer_transducer_tpu_torch.utils.device import resolve_device
    from transformer_transducer_tpu_torch.utils.metrics import batch_cer
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    apply_overrides(cfg, args.overrides)
    vocab = Vocabulary.from_file(cfg.data.vocab)
    left_ctx, right_ctx = stack_context(cfg.data)
    d_in = (cfg.data.feature_dim or 128) * (1 + left_ctx + right_ctx)
    model = load_family(cfg, d_in, args.checkpoint, device=device,
                        flash=args.full_context, int8=args.int8)

    wave, rate = read_wave(args.wav)
    feats = F.subsample(F.stack_frames(
        F.logmel_masked(wave, rate, cfg.data.feature_dim or 128),
        left_ctx, right_ctx), subsample_factor(cfg.data))
    band = None if args.full_context or is_espnet_config(cfg.model) else (
        cfg.model.enc.left_context or 10, cfg.model.enc.right_context or 2)
    x = torch.from_numpy(feats[None]).to(device)
    max_tokens = cfg.data.max_target_length + 1
    decode = recognize_beam if args.beam else recognize
    pred = decode(model, x, [feats.shape[0]], band=band, max_tokens=max_tokens)[0]

    text = "".join(vocab.decode(pred))
    print("识别结果 / prediction:", text)
    if args.truth:
        dist, total = batch_cer([list(text)], [list(args.truth)])
        print(f"truth: {args.truth}")
        print(f"CER: {100.0 * dist / max(total, 1):.2f}%")
    return text


if __name__ == "__main__":
    main()
