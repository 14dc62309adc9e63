"""Full-context relative-position attention's forward against its
roofline: the least time of its work on true lengths at the card's peaks
over the device time of its kernels, in %."""


def read(run):
    return run.roofline_pct("flash_attn_fwd")
