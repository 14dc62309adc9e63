"""PyTorch port: batched multi-stream serving (``streaming/batched.py`` and the
batched cached-encoder step of ``streaming/incremental.py``) held against
the JAX package's ``BatchedStreamingSession`` and against the port's solo
session on the same weights and int16 audio; mirrors
``tests/test_batched_streaming.py`` (its espnet test is in
``tests/test_torch_port_espnet_streaming.py``; here a test that
the family raises).

Tokens, timestamps and segments must be equal; confidences and encoder
states within ``TOL`` (rtol 2e-4, atol 2e-5).  Shapes are small: 2 encoder
layers, d_model 64, band (10, 2), windows pinned at 64 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.streaming import batched as jax_batched
from transformer_transducer_tpu.streaming import incremental as jax_incremental
from transformer_transducer_tpu_torch.streaming import incremental
from transformer_transducer_tpu_torch.streaming.batched import BatchedStreamingSession
from transformer_transducer_tpu_torch.streaming.session import StreamingSession

from test_torch_port_streaming import emitting_models, feed, jax_scfg, scfg, wave
from torch_port_helpers import TOL

torch.set_num_threads(1)

MODES = [False, True]                    # window rounds, cached-encoder rounds
SPLIT = dict(window_len=64, blank_split=4)


def waves(seeds, lengths):
    """Tones in noise, silent for part of each period so that blank runs
    split sentences; each several windows long."""
    return [wave(n, seed=s, freq=0.02 + 0.005 * s, gate=9000)
            for s, n in zip(seeds, lengths)]


@pytest.fixture(scope="module")
def models():
    return emitting_models(seed=5, share=0.25)


def solo_streams(pm, wavs, incremental, hop=2500):
    return [feed(StreamingSession(pm, scfg(**SPLIT), device="cpu", incremental=incremental),
                 w, hop) for w in wavs]


def assert_streams_equal(got, ref):
    """Per-stream tokens, timestamps and segments equal, confidences within
    TOL (``got``/``ref``: objects with those four lists)."""
    assert any(r.result for r in ref), "degenerate test: nothing was emitted"
    assert [g.result for g in got] == [r.result for r in ref]
    assert [g.timestamps for g in got] == [r.timestamps for r in ref]
    assert [[s for s in g.segments if s] for g in got] == \
        [[s for s in r.segments if s] for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.confidences, r.confidences, **TOL)


def fed_whole(session, wavs):
    for i, w in enumerate(wavs):
        session.accept_waveform(i, w)
        session.finalize(i)
    return session


def jax_session(models, n, incremental):
    jm, variables, _ = models
    return jax_batched.BatchedStreamingSession(jm, variables, jax_scfg(**SPLIT), n_streams=n,
                                               incremental=incremental)


# ---------------------------------------------------------------------------
# The batched cached-encoder step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("left,right,chunk", [(10, 2, 8), (3, 3, 16)])
def test_batched_step_matches_solo_step_and_jax_vmapped(models, left, right, chunk):
    """Ragged ``n_new`` (a stream may sit a step out with 0) and a key limit
    a stream: stream by stream the solo step on its valid rows, and the JAX
    step ``vmap``ped over the streams; a stream with ``n_new`` 0 keeps its
    cache."""
    jm, variables, pm = models
    n_layer, d = 2, 64
    layers = incremental.prepare_layers(pm, left, right, 64)
    jcfg = jax_scfg(left_context=left, right_context=right, window_len=64)
    stack, _, jstep = jax_incremental.make_incremental_encoder(jm, variables, jcfg)
    vstep = jax.jit(jax.vmap(lambda c, x, n, kl: jstep(stack, c, x, n, kl)))
    n_new = np.array([[chunk, chunk, 3, 0, chunk, 1],
                      [5, chunk, chunk, chunk, 2, chunk],
                      [chunk, 1, 0, chunk, chunk, chunk]], np.int64)
    key_limit = np.array([incremental._BIG, 30, 22], np.int64)
    n_streams = n_new.shape[0]
    rng = np.random.RandomState(left + right)
    solo = [incremental.init_cache(n_layer, left, right, d) for _ in range(n_streams)]
    cache = incremental.init_batched_cache(n_streams, n_layer, left, right, d)
    one = jax_incremental.init_cache(n_layer, left, right, d)
    jcache = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n_streams,) + x.shape),
                                    one)
    for step in range(n_new.shape[1]):
        x = np.zeros((n_streams, chunk, d), np.float32)
        for i in range(n_streams):
            x[i, :n_new[i, step]] = rng.randn(n_new[i, step], d)
        with torch.no_grad():
            new, out, start = incremental.batched_encode_step(
                layers, cache, torch.from_numpy(x), torch.from_numpy(n_new[:, step]),
                torch.from_numpy(key_limit), left=left, right=right)
        jcache, jout, jstart = vstep(jcache, jnp.asarray(x),
                                     jnp.asarray(n_new[:, step], jnp.int32),
                                     jnp.asarray(key_limit, jnp.int32))
        assert start.tolist() == np.asarray(jstart).tolist()
        np.testing.assert_allclose(new["bufs"].numpy(), np.asarray(jcache["bufs"]), **TOL)
        assert new["n_in"].tolist() == np.asarray(jcache["n_in"]).tolist()
        for i in range(n_streams):
            n = int(n_new[i, step])
            # the rows the caller reads: positions in [0, key_limit) (a flush
            # row whose keys are all masked is garbage in either package)
            rows = [j for j in range(n) if 0 <= int(start[i]) + j < key_limit[i]]
            np.testing.assert_allclose(out[i, rows].numpy(), np.asarray(jout)[i, rows], **TOL)
            if n == 0:
                assert torch.equal(new["bufs"][i], cache["bufs"][i])
                continue
            with torch.no_grad():
                solo[i], ref, ref_start = incremental.incremental_encode_step(
                    layers, solo[i], torch.from_numpy(x[i, :n]), int(key_limit[i]),
                    left=left, right=right)
            assert int(start[i]) == ref_start
            np.testing.assert_allclose(out[i, :n].numpy(), ref.numpy(), **TOL)
            np.testing.assert_allclose(new["bufs"][i].numpy(), solo[i]["bufs"].numpy(),
                                       **TOL)
            assert bool(torch.isfinite(out).all())
        cache = new


# ---------------------------------------------------------------------------
# The batched session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("incremental_mode", MODES)
def test_batched_matches_solo_sessions_and_jax(models, incremental_mode):
    """Streams fed whole and drained equal solo sessions fed 2500 samples a
    call, and the JAX batched session."""
    _, _, pm = models
    wavs = waves([0, 1, 2], [30000, 41000, 52000])
    batched = fed_whole(BatchedStreamingSession(pm, scfg(**SPLIT), 3,
                                                incremental=incremental_mode, device="cpu"),
                        wavs)
    results = batched.run_to_completion()
    assert results == [st.result for st in batched.streams]
    assert batched.rounds > 1 and batched.windows >= batched.rounds
    assert_streams_equal(batched.streams, solo_streams(pm, wavs, incremental_mode))
    ref = fed_whole(jax_session(models, 3, incremental_mode), wavs)
    ref.run_to_completion()
    assert_streams_equal(batched.streams, ref.streams)
    assert any(len([s for s in st.segments if s]) > 1 for st in batched.streams), \
        "degenerate test: no split"
    for st in batched.streams:
        assert all(c <= 0.0 for c in st.confidences)


@pytest.mark.parametrize("incremental_mode", MODES)
def test_batched_incremental_feeding(models, incremental_mode):
    """Audio arriving 3000 samples a call with a ``process()`` after each:
    what was emitted is a prefix of the drained result, which equals the
    JAX session's under the same feed and a solo session's."""
    _, _, pm = models
    wavs = waves([7, 8], [36000, 36000])
    port = BatchedStreamingSession(pm, scfg(**SPLIT), 2, incremental=incremental_mode,
                                   device="cpu")
    ref = jax_session(models, 2, incremental_mode)
    emitted, jax_emitted = [[], []], [[], []]
    for pos in range(0, 36000, 3000):
        for session in (port, ref):
            for i in range(2):
                session.accept_waveform(i, wavs[i][pos:pos + 3000])
        for i, new in enumerate(port.process()):
            emitted[i] += new
        for i, new in enumerate(ref.process()):
            jax_emitted[i] += new
    assert emitted == jax_emitted and any(emitted), "degenerate test: nothing emitted live"
    for session in (port, ref):
        for i in range(2):
            session.finalize(i)
    results = port.run_to_completion()
    ref.run_to_completion()
    for i in range(2):
        assert results[i][:len(emitted[i])] == emitted[i]
        assert sum(port.streams[i].segments, []) == results[i]
    assert_streams_equal(port.streams, ref.streams)
    assert_streams_equal(port.streams, solo_streams(pm, wavs, incremental_mode, hop=3000))


@pytest.mark.parametrize("incremental_mode", MODES)
def test_stacked_drain_matches_round_by_round(models, incremental_mode):
    """``run_to_completion`` (the rounds of a group encoded in one call,
    then decoded round by round) equals repeated ``process()`` exactly."""
    _, _, pm = models
    wavs = waves([11, 12, 13], [39000, 48000, 27000])

    def session():
        return fed_whole(BatchedStreamingSession(pm, scfg(**SPLIT), 3,
                                                 incremental=incremental_mode, device="cpu"),
                         wavs)

    by_round = session()
    while any(by_round.process()):
        pass
    stacked = session()
    results = stacked.run_to_completion()
    assert results == [st.result for st in by_round.streams] and any(results)
    assert [st.timestamps for st in stacked.streams] == \
        [st.timestamps for st in by_round.streams]
    assert [st.segments for st in stacked.streams] == [st.segments for st in by_round.streams]
    assert stacked.rounds == by_round.rounds > 1
    # one encoder call a group of rounds (window), one step a round (incremental)
    assert by_round.encode_calls == by_round.rounds
    assert stacked.encode_calls == (stacked.rounds if incremental_mode else 1)


def test_espnet_family_waits_for_a_later_slice():
    import os
    from transformer_transducer_tpu_torch.streaming.session import StreamingConfig
    from transformer_transducer_tpu_torch.utils.config import load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "espnet_aishell.yaml"))
    # the family is served now: its band, blocks and sos seed come from the
    # config (tests/test_torch_port_espnet_streaming.py drives it)
    scfg = StreamingConfig.from_config(cfg)
    assert (scfg.left_context, scfg.right_context, scfg.n_layer, scfg.seed_token) == \
        (10, 2, 8, 4232)


@pytest.mark.parametrize("incremental_mode", MODES)
def test_host_reads_within_one_plus_emissions_a_round(models, incremental_mode):
    """Each round reads the device at most 1 + the most emissions of one
    stream in it, and at least once when any stream had rows."""
    _, _, pm = models
    wavs = waves([3, 4, 5], [52000, 66000, 20000])
    session = fed_whole(BatchedStreamingSession(pm, scfg(**SPLIT), 3,
                                                incremental=incremental_mode, device="cpu"),
                        wavs)
    rounds = 0
    while True:
        reads = session.host_reads
        new = session.process()
        if not any(new) and session.rounds == rounds:
            break
        rounds = session.rounds
        assert session.host_reads - reads <= 1 + max(len(t) for t in new)
    assert rounds > 2 and any(st.result for st in session.streams)
    assert session.host_reads <= session.read_bound


# ---------------------------------------------------------------------------
# Continuous batching (per-slot turnover; serve_files)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("incremental_mode", MODES)
def test_continuous_slot_reuse(models, incremental_mode):
    """5 utterances of mixed length through 2 slots: each equals its solo
    session and the JAX ``serve_files``; a drained slot's reset never
    disturbs the stream still decoding beside it."""
    _, _, pm = models
    wavs = waves(range(20, 25), [18000 + 9000 * (s % 3) for s in range(5)])
    solo = solo_streams(pm, wavs, incremental_mode)
    session = BatchedStreamingSession(pm, scfg(**SPLIT), 2, incremental=incremental_mode,
                                      device="cpu")
    results = session.serve_files(wavs)
    ref = jax_session(models, 2, incremental_mode)
    ref_results = ref.serve_files(wavs)
    assert results == [s.result for s in solo] == ref_results
    for k in range(len(wavs)):
        meta = session.last_meta[k]
        assert meta["timestamps"] == solo[k].timestamps == ref.last_meta[k]["timestamps"]
        assert meta["segments"] == [s for s in solo[k].segments if s]
        np.testing.assert_allclose(meta["confidences"], solo[k].confidences, **TOL)
    stats = session.last_stats
    assert stats["rounds"] == ref.last_stats["rounds"]
    assert stats["slot_utilization"] == pytest.approx(ref.last_stats["slot_utilization"])
    assert 0.0 < stats["slot_utilization"] <= 1.0
    assert len(stats["utt_latency_s"]) == 5 and all(x > 0 for x in stats["utt_latency_s"])


def decode_state(session):
    """Copies of a batched session's per-stream decode state: label rings,
    label projections, fill counts, blank runs and, in incremental mode,
    the encoder caches."""
    state = {"buf": session._buf, "proj": session._dec_proj,
             "count": torch.from_numpy(session._count),
             "blank": torch.from_numpy(session._blank_run)}
    if session.incremental:
        state.update(bufs=session._cache["bufs"], n_in=session._cache["n_in"])
    return {k: v.clone() for k, v in state.items()}


@pytest.mark.parametrize("incremental_mode", MODES)
def test_reset_streams_leaves_other_streams_bit_identical(models, incremental_mode):
    """``reset_streams`` re-seeds the given slots' rings, counts, label
    projections and caches, and leaves every other stream's to the bit."""
    _, _, pm = models
    wavs = waves([30, 31, 32], [30000, 30000, 30000])
    session = BatchedStreamingSession(pm, scfg(**SPLIT), 3, incremental=incremental_mode,
                                      device="cpu")
    for i, w in enumerate(wavs):
        session.accept_waveform(i, w[:20000])
    for _ in range(3):
        session.process()
    assert all(st.result for st in session.streams), "degenerate test: nothing emitted"

    before, kept = decode_state(session), list(session.streams)
    session.reset_streams([1])
    after = decode_state(session)
    fresh = decode_state(BatchedStreamingSession(pm, scfg(**SPLIT), 3,
                                                 incremental=incremental_mode, device="cpu"))
    for name in before:
        for i in (0, 2):
            assert torch.equal(before[name][i], after[name][i]), name
        assert torch.equal(after[name][1], fresh[name][1]), name
    # the other streams' host pipelines are the same objects; the slot's is new
    assert [session.streams[i] is kept[i] for i in range(3)] == [True, False, True]
    assert session.streams[1].result == [] and session.streams[1].fed == 0
    # the reset slot takes a new stream; the others finish as if nothing happened
    session.accept_waveform(1, wavs[1])
    for i in (0, 2):
        session.accept_waveform(i, wavs[i][20000:])
    for i in range(3):
        session.finalize(i)
    session.run_to_completion()
    assert_streams_equal(session.streams, solo_streams(pm, wavs, incremental_mode))
