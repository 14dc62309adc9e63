"""The streaming band's attention, forward and backward, against its
roofline: the least time of its work on true lengths at the card's peaks
over the device time of its kernels, in %."""


def read(run):
    return run.roofline_pct("banded_attn_fwd", "banded_attn_bwd")
