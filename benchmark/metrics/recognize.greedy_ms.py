"""The mean time a batch of the traced window spent in the greedy loop
(``greedy_decode``) and the tokens' copy to the host: the benchmark's own
span, host clock ending in a synchronise."""


def read(run):
    times = run.ctx.spans.times.get("greedy")
    return 1e3 * sum(times) / len(times) if times else None
