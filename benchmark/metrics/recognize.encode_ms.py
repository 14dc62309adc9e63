"""The mean time a batch of the traced window spent in the log-mel and the
encoder (``extract_batch_padded`` and ``encode_for_decoding``, with the
batch's copy to the card): the benchmark's own span, host clock ending in
a synchronise."""


def read(run):
    times = run.ctx.spans.times.get("encode")
    return 1e3 * sum(times) / len(times) if times else None
