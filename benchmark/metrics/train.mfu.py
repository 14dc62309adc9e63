"""The whole training step's share of the card's peak: the model's
operations over the traced window (three times the forward on true
lengths: encoder, label encoder, joint, or for the pruned loss the joint
on its bands and the linearized joint; recomputation not counted) over
the window's seconds at 495 TFLOP/s (``benchmark/harness.py``)."""

from benchmark.harness import PEAK_FLOP_PER_S
from benchmark.work.counts import train_fwd, utterances


def read(run):
    cfg = run.ctx.cfg
    s_range = run.ctx.traffic.get("pruned_range")
    flops = sum(3.0 * train_fwd(u, cfg, s_range) for r in run.records
                for u in utterances(cfg, r))
    return 100.0 * flops / (run.window_s * PEAK_FLOP_PER_S) if flops else None
