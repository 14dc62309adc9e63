"""The most memory the window's steps held on the card
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GiB: it caps the batch a user can train at."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
