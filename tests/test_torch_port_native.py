"""PyTorch port: the native C++ runtime (``runtime/native.py`` over the
port's own ``csrc/ttx_runtime.cc``) and its branches in ``utils/metrics.py``
and ``ops/features_np.py``, held against the JAX package's functions on the
same seeded inputs: the edit distances and batch CER equal, the log-mel
within rtol 2e-4 and atol 2e-4 (JAX's own bar for its featurizer), float
waves unchanged to the bit, ``parse_wav`` on a round trip and on malformed
headers.  A failed build raises with the compiler's output; only without a
compiler do the numpy paths run; processes that build at once land one
library."""

import logging
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from transformer_transducer_tpu.ops import features_np as jax_F
from transformer_transducer_tpu.utils.metrics import _levenshtein_numpy as jax_levenshtein
from transformer_transducer_tpu.utils.metrics import batch_cer as jax_batch_cer
from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.ops.cuda import build as cuda_build
from transformer_transducer_tpu_torch.runtime import native
from transformer_transducer_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def lib():
    if native.compiler() is None:
        pytest.skip("no C++ compiler here")
    return native.library()


def _ids(rng, n_max, vocab=6):
    return list(rng.randint(0, vocab, rng.randint(0, n_max)))


def _wave(n, seed, scale=3000.0):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.int16)


@pytest.mark.parametrize("seed", [0, 1])
def test_levenshtein_matches_jax(lib, seed):
    rng = np.random.RandomState(seed)
    before = native.read_calls()["levenshtein"]
    for _ in range(50):
        a, b = _ids(rng, 20), _ids(rng, 20)
        want = jax_levenshtein(a, b)
        assert lib.levenshtein(np.array(a, np.int32), np.array(b, np.int32)) == want
        assert metrics.levenshtein(a, b) == metrics.levenshtein_numpy(a, b) == want
    assert native.read_calls()["levenshtein"] - before == 100
    # strings take numpy
    assert metrics.levenshtein("kitten", "sitting") == jax_levenshtein("kitten", "sitting") == 3
    assert native.read_calls()["levenshtein"] - before == 100


def test_batch_cer_matches_jax_in_one_call(lib):
    rng = np.random.RandomState(2)
    preds = [_ids(rng, 30, 40) for _ in range(300)]
    refs = [_ids(rng, 30, 40) for _ in range(300)]
    want = jax_batch_cer([list(map(str, p)) for p in preds], [list(map(str, r)) for r in refs])
    before = native.read_calls()["batch_levenshtein"]
    assert metrics.batch_cer(preds, refs) == want == metrics.batch_cer_numpy(preds, refs)
    assert want[1] == sum(map(len, refs))
    assert native.read_calls()["batch_levenshtein"] - before == 1
    # symbol strings go pair by pair through numpy
    text_p, text_r = [list("abc"), list("xy")], [list("abd"), list("")]
    assert metrics.batch_cer(text_p, text_r) == jax_batch_cer(text_p, text_r) == (3, 3)
    assert native.read_calls()["batch_levenshtein"] - before == 1
    assert lib.batch_levenshtein([[1, 2, 3], [4, 5], []], [[1, 2, 4], [4, 5, 6], [7]]) == (3, 7)
    with pytest.raises(ValueError, match="2 predictions against 1"):
        metrics.batch_cer([[1], [2]], [[1]])


@pytest.mark.parametrize("variant", ["masked", "eps"])
def test_native_logmel_matches_jax(lib, variant, monkeypatch):
    monkeypatch.delenv("TTX_NATIVE_FEATURES", raising=False)
    jax_fn = jax_F.logmel_masked if variant == "masked" else jax_F.logmel_eps
    for n, n_mels, seed in ((16000, 32, 7), (4321, 128, 8), (257, 16, 9)):
        wav = _wave(n, seed)
        got = lib.logmel(wav, F.mel_filterbank(16000, 512, n_mels), 512, 160, variant)
        want = jax_fn(wav, 16000, n_mels)
        assert got.shape == want.shape == (1 + n // 160, n_mels)
        np.testing.assert_allclose(got, want, **FEAT_TOL)
    # a wave too short for the reflect pad is refused: the caller takes numpy
    assert lib.logmel(_wave(256, 1), F.mel_filterbank(16000, 512, 16), 512, 160, variant) is None


def test_where_native_and_numpy_part_numpys_float32_is_the_farther(lib):
    """On voiced waves at 128 mels (``chip_smoke.py``'s phase 4 batch, two
    of its waves), a mel bin holding little of a frame's energy takes the
    float32 FFT's rounding of the numpy path: a few 1e-4 in its log.
    ``ttx_logmel`` (float64 throughout) holds 2e-4 against the same
    pipeline in float64, and where it leaves 2e-4 of numpy, numpy's float32
    is the farther from float64 (the check phase 15 makes on the card)."""
    import chip_smoke
    waves = chip_smoke.synthetic_waves(8, seed=0)
    mel = F.mel_filterbank(16000, 512, 128)
    outside = 0
    for w in (waves[6], waves[2]):
        frames = F.frame_signal(w).astype(np.float64) * F.hann_window()[None]
        spec = np.fft.rfft(frames, axis=-1)
        ref = np.log((spec.real ** 2 + spec.imag ** 2) @ mel.T.astype(np.float64))
        got = lib.logmel(w, mel, 512, 160, "masked")
        want = jax_F.logmel_masked(w, 16000, 128)
        np.testing.assert_allclose(got, ref, **FEAT_TOL)
        off = np.abs(got - want) > 2e-4 + 2e-4 * np.abs(want)
        assert (np.abs(want - ref)[off] > np.abs(got - ref)[off]).all()
        outside += int(off.sum())
    assert outside >= 1


def test_native_features_routing(lib, monkeypatch):
    """``TTX_NATIVE_FEATURES=1`` routes int16 waves through ``ttx_logmel``;
    float waves, and every wave without it, take numpy to the bit of JAX's."""
    monkeypatch.delenv("TTX_NATIVE_FEATURES", raising=False)
    wav = _wave(12000, 10, 2000.0)
    flt = wav.astype(np.float32)
    want = {"eps": jax_F.logmel_eps(wav, 16000, 16),
            "masked": jax_F.logmel_masked(wav, 16000, 16)}
    want_flt = jax_F.logmel_masked(flt, 16000, 16)
    before = native.read_calls()["logmel"]
    np.testing.assert_array_equal(F.logmel_eps(wav, 16000, 16), want["eps"])
    assert native.read_calls()["logmel"] == before
    monkeypatch.setenv("TTX_NATIVE_FEATURES", "1")
    for variant, fn in (("eps", F.logmel_eps), ("masked", F.logmel_masked)):
        got = fn(wav, 16000, 16)
        np.testing.assert_array_equal(
            got, lib.logmel(wav, F.mel_filterbank(16000, 512, 16), 512, 160, variant))
        np.testing.assert_allclose(got, want[variant], **FEAT_TOL)
    assert native.read_calls()["logmel"] - before == 4
    np.testing.assert_array_equal(F.logmel_masked(flt, 16000, 16), want_flt)
    feats = F.extract(wav, 16000, 16)
    assert feats.shape == jax_F.extract(wav, 16000, 16).shape
    assert native.read_calls()["logmel"] - before == 5


def test_parse_wav_round_trip(lib, tmp_path):
    samples = _wave(4321, 1, 5000.0)
    path = tmp_path / "t.wav"
    write_wave(str(path), samples, 16000)
    got, rate = lib.parse_wav(path.read_bytes())
    assert rate == 16000
    np.testing.assert_array_equal(got, samples)


def test_parse_wav_rejects_malformed_headers(lib):
    """A truncated fmt chunk, zero channels, 8-bit samples and a short file
    all give None (JAX ``tests/test_native_runtime.py:87-101``)."""
    truncated = b"RIFF" + b"\x24\x00\x00\x00" + b"WAVE" + b"fmt " + b"\x10\x00\x00\x00" + b"\x00\x00"

    def riff(channels, bits):
        fmt = struct.pack("<HHIIHH", 1, channels, 16000, 32000, 2, bits)
        return (b"RIFF" + struct.pack("<I", 40) + b"WAVE" + b"fmt " + struct.pack("<I", 16)
                + fmt + b"data" + struct.pack("<I", 4) + b"\x00" * 4)

    assert lib.parse_wav(riff(1, 16)) is not None
    for blob in (truncated, riff(0, 16), riff(1, 8), b"RIFF", b"RIFX" + riff(1, 16)[4:]):
        assert lib.parse_wav(blob) is None


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'ttx_runtime.cc:1: error: the fake compiler refuses' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.delenv("TTX_RUNTIME_LIB", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", None)
    with pytest.raises(RuntimeError, match="the fake compiler refuses"):
        native.library_or_none()
    with pytest.raises(RuntimeError, match="the fake compiler refuses"):
        metrics.batch_cer([[1, 2]], [[1, 3]])
    monkeypatch.setenv("TTX_NATIVE_FEATURES", "1")
    with pytest.raises(RuntimeError, match="the fake compiler refuses"):
        F.logmel_eps(_wave(4000, 2), 16000, 16)
    assert not list((tmp_path / "build").glob("*.so"))
    # a named library that is not one raises too
    bad = tmp_path / "not_a_library.so"
    bad.write_bytes(b"\x7fELF garbage")
    monkeypatch.setenv("TTX_RUNTIME_LIB", str(bad))
    with pytest.raises(RuntimeError, match="cannot load the native runtime"):
        native.library_or_none()


def test_without_a_compiler_numpy_runs_and_the_log_says_so_once(monkeypatch, caplog):
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    monkeypatch.delenv("TTX_RUNTIME_LIB", raising=False)
    monkeypatch.setattr(native, "_loaded", None)
    monkeypatch.setattr(native, "_said_numpy", False)
    monkeypatch.delenv("TTX_NATIVE_FEATURES", raising=False)
    wav = _wave(3000, 3)
    want = jax_F.logmel_eps(wav, 16000, 16)
    monkeypatch.setenv("TTX_NATIVE_FEATURES", "1")
    before = native.read_calls()
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert metrics.batch_cer([[1, 2, 3]], [[1, 3]]) == (1, 2)
        np.testing.assert_array_equal(F.logmel_eps(wav, 16000, 16), want)
        with pytest.raises(RuntimeError, match="needs a C\\+\\+ compiler"):
            native.library()
    assert native.read_calls() == before
    assert sum("no C++ compiler" in r.getMessage() for r in caplog.records) == 1


def test_runtime_lib_names_the_library_to_load(lib, monkeypatch):
    path = native.library_path(native.compiler())
    assert path.exists() and path.parent == native.BUILD_DIR
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    monkeypatch.setenv("TTX_RUNTIME_LIB", str(path))
    monkeypatch.setattr(native, "_loaded", None)
    assert native.library_or_none().levenshtein([1, 2, 3], [1, 3]) == 1


def test_concurrent_builds_land_one_library(lib, tmp_path):
    """Four processes build into one empty directory at once: one library,
    no temporary directory left, and each process loads it."""
    code = ("import sys\nfrom pathlib import Path\n"
            "from transformer_transducer_tpu_torch.runtime import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "print(native.build().name, native.library().levenshtein([1, 2], [2]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {out.split()[0] for out, _ in outs}
    assert all(out.split()[1] == "1" for out, _ in outs)
    assert [p.name for p in tmp_path.iterdir()] == list(names)
    assert len(names) == 1 and next(iter(names)).startswith("libttx_runtime_")


def test_the_ports_source_and_the_cuda_build_are_apart():
    """The port's copy keeps the root source's edit distances and WAV
    parser to the character and its four entry points, lives beside the
    CUDA sources, and the CUDA build neither compiles it nor hashes it."""
    with open(os.path.join(ROOT, "csrc", "ttx_runtime.cc")) as fh:
        root = fh.read()
    port = native.SOURCE.read_text()
    start, end = "extern \"C\" {", "// Native log-mel featurizer"
    assert port[port.index(start):port.index(end)] == root[root.index(start):root.index(end)]
    for name in ("ttx_levenshtein", "ttx_batch_levenshtein", "ttx_parse_wav", "ttx_logmel"):
        assert f" {name}(" in port
    assert "#pragma omp" not in port and "_OPENMP" not in port
    assert native.SOURCE.parent == cuda_build.SOURCES[0].parent
    assert all(p.suffix in (".cu", ".cuh") for p in cuda_build.SOURCES + cuda_build.HEADERS)
    assert native.BUILD_DIR.parent == cuda_build.BUILD_DIR.parent
    assert native.BUILD_DIR != cuda_build.BUILD_DIR


@pytest.mark.parametrize("threads", ["1", "3", None])
def test_threaded_logmel_equals_the_root_sources_openmp_build(lib, tmp_path, monkeypatch, threads):
    """The root ``csrc/ttx_runtime.cc`` built with its Makefile's flags
    (OpenMP) into a temporary directory, loaded as the JAX package loads
    it: the port's threaded featurizer gives its output to the bit, with
    one thread, three, and one a core."""
    import ctypes

    from transformer_transducer_tpu.runtime.native import _Native as JaxNative
    out = str(tmp_path / "libroot.so")
    proc = subprocess.run([native.compiler(), "-O3", "-std=c++17", "-fPIC", "-Wall", "-fopenmp",
                           "-shared", "-o", out, os.path.join(ROOT, "csrc", "ttx_runtime.cc")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip(f"this compiler cannot build the root source with OpenMP: {proc.stderr}")
    root_lib = JaxNative(ctypes.CDLL(out))
    if threads is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", threads)
    for n, n_mels in ((16000, 128), (4000, 40), (257, 16), (1377, 80)):
        wav = _wave(n, n_mels)
        mel = F.mel_filterbank(16000, 512, n_mels)
        for variant in ("masked", "eps"):
            np.testing.assert_array_equal(lib.logmel(wav, mel, 512, 160, variant),
                                          root_lib.logmel(wav, mel, 512, 160, variant))
