"""Full-context relative-position attention, forward and backward, in
training, against its roofline: the least time of its work on true
lengths at the card's peaks over the device time of its kernels, in %."""


def read(run):
    return run.roofline_pct("flash_attn_fwd", "flash_attn_bwd")
