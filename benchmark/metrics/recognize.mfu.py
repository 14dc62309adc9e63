"""The whole recognize call's share of the card's peak: the operations of
the log-mel, the encoder and the greedy loop's joint and label steps on
true lengths over the traced window's seconds at 495 TFLOP/s."""

from benchmark.harness import PEAK_FLOP_PER_S
from benchmark.work.counts import band_of, encoder_fwd, frontend, greedy, utterances


def read(run):
    cfg = run.ctx.cfg
    model = cfg["model"]
    flops = sum(frontend(u) + encoder_fwd(u, model["enc"], band_of(cfg)) + greedy(u, model)
                for r in run.records for u in utterances(cfg, r))
    return 100.0 * flops / (run.window_s * PEAK_FLOP_PER_S) if flops else None
