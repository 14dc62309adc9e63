"""The backward of full-context relative-position attention (kernel 9 today), every
encoder layer, counted on true lengths (``benchmark/work/counts.py``
says why)."""

from benchmark.work.counts import attention_bwd, each_layer_call


def count(run):
    """(operations, bytes) of each step's or batch's calls."""
    if run.ctx.cfg["encoder"] != "flash":
        return []
    return list(each_layer_call(run, attention_bwd, training_only=True))
