"""The share of the traced window in which no kernel, copy or fill ran on
the card (``torch.profiler``'s device activities, their union)."""


def read(run):
    return 100.0 * (1.0 - run.busy_s / run.window_s) if run.busy_s else None
