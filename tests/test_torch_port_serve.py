"""PyTorch port: the serving CLI (``apps/serve.py``) and the record, gui and
demo apps; mirrors ``tests/test_serve_cli.py``.

Each CLI test runs the port's ``serve --device cpu`` on a checkpoint the
port wrote (the JAX weights through ``utils/convert.py::from_jax_params``)
and the root JAX ``apps/serve.py`` on the same weights and wavs: each
file's tokens must be equal.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from transformer_transducer_tpu_torch.apps import demo, record, serve, stream_demo
from transformer_transducer_tpu_torch.data.wav import read_wave, write_wave
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

from data_helpers import tiny_train_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_app(name):
    spec = importlib.util.spec_from_file_location(f"ttx_root_{name}",
                                                  os.path.join(ROOT, "apps", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny config, its vocabulary, the same weights as a JAX checkpoint
    and as a port ``state_dict`` file."""
    from transformer_transducer_tpu.models.factory import build_family
    from transformer_transducer_tpu.utils import checkpoint as ckpt_lib
    from transformer_transducer_tpu.utils.config import dump_config
    tmp = tmp_path_factory.mktemp("serve")
    vocab_path = tmp / "vocab.txt"
    vocab_path.write_text("<b> 0\n" + "".join(f"w{i} {i}\n" for i in range(1, 12)))
    cfg = tiny_train_config(str(tmp), str(vocab_path), {"train": "x", "dev": "x", "test": "x"})
    dump_config(cfg, str(tmp / "cfg.yaml"))
    _, variables, _ = build_family(cfg, 16)
    jax_ckpt = ckpt_lib.save_checkpoint(str(tmp / "ck"), variables["params"])
    torch.save(from_jax_params(variables["params"]), tmp / "model.pt")
    return {"dir": tmp, "cfg": str(tmp / "cfg.yaml"), "jax_ckpt": jax_ckpt,
            "port_ckpt": str(tmp / "model.pt")}


def _wavs(directory, lengths, step=0.01):
    rng = np.random.RandomState(0)
    paths = []
    for s, n in enumerate(lengths):
        w = np.sin(np.arange(n) * (0.02 + step * s)) * 9000 + rng.randn(n) * 1500
        path = str(directory / f"in{s}_{n}.wav")
        write_wave(path, w)
        paths.append(path)
    return paths


def _run_both(served, wavs, extra, monkeypatch, capsys):
    """The port's CLI on the CPU, then the root JAX CLI, with the same flags;
    each one's stdout as JSON records."""
    argv = ["--config", served["cfg"], "--wavs", *wavs, "--streams", "2", "--json", *extra]
    serve.main(["--checkpoint", served["port_ckpt"], "--device", "cpu", *argv])
    port = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    monkeypatch.setattr(sys, "argv", ["serve.py", "--checkpoint", served["jax_ckpt"], *argv])
    _root_app("serve").main()
    ref = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    return port, ref


def _files(records):
    return [r for r in records if "file" in r]


@pytest.mark.parametrize("incremental", [False, True])
def test_serve_json_output(served, monkeypatch, capsys, incremental):
    wavs = _wavs(served["dir"], [16000, 20000])
    port, ref = _run_both(served, wavs, ["--incremental"] if incremental else [],
                          monkeypatch, capsys)
    assert len(port) == 2
    assert [r["tokens"] for r in port] == [r["tokens"] for r in ref]
    assert any(r["tokens"] for r in port), "degenerate test: no stream emitted anything"
    for rec, jrec, path in zip(port, ref, wavs):
        assert rec["file"] == path
        n = len(rec["tokens"])
        assert rec["times_s"] == jrec["times_s"] and rec["segments"] == jrec["segments"]
        assert len(rec["times_s"]) == n and len(rec["confidences"]) == n
        assert all(b > a for a, b in zip(rec["times_s"], rec["times_s"][1:]))
        assert all(0.0 < c <= 1.0 for c in rec["confidences"])
        np.testing.assert_allclose(rec["confidences"], jrec["confidences"], atol=2e-5)
        assert rec["text"] == "".join(f"w{t}" for t in rec["tokens"])


def test_serve_latency_summary(served, monkeypatch, capsys):
    """``--latency`` drains round by round and ends with the summary line;
    each file's tokens equal the stacked drain's and the JAX CLI's."""
    wavs = _wavs(served["dir"], [16000, 20000])
    plain, _ = _run_both(served, wavs, [], monkeypatch, capsys)
    lat, ref = _run_both(served, wavs, ["--latency"], monkeypatch, capsys)
    assert len(lat) == 3 and "summary" in lat[-1]
    assert [r["tokens"] for r in lat[:2]] == [r["tokens"] for r in plain] == \
        [r["tokens"] for r in _files(ref)]
    s = lat[-1]["summary"]
    assert set(s) == set(ref[-1]["summary"])
    rl = s["round_latency_ms"]
    assert set(rl) == {"mean", "p50", "p95", "p99"}
    assert 0 < rl["p50"] <= rl["p95"] <= rl["p99"]
    assert s["rounds"] == ref[-1]["summary"]["rounds"] > 0
    for path in [r["file"] for r in lat[:2] if r["tokens"]]:
        assert s["first_token_ms"][path] > 0


def test_serve_continuous_batching(served, monkeypatch, capsys):
    """``--continuous``: 5 files of skewed lengths through 2 slots; each
    file's tokens equal the gang-scheduled mode's and the JAX CLI's, and the
    summary reports slot utilization and latency percentiles."""
    wavs = _wavs(served["dir"], [40000, 12000, 14000, 16000, 12000], step=0.007)
    gang, _ = _run_both(served, wavs, [], monkeypatch, capsys)
    cont, ref = _run_both(served, wavs, ["--continuous"], monkeypatch, capsys)
    assert len(cont) == len(wavs) + 1 and "summary" in cont[-1]
    assert [r["file"] for r in cont[:-1]] == wavs
    assert [r["tokens"] for r in cont[:-1]] == [r["tokens"] for r in gang] == \
        [r["tokens"] for r in _files(ref)]
    s, js = cont[-1]["summary"], ref[-1]["summary"]
    assert set(s) == set(js)
    assert s["mode"] == "continuous" and s["slots"] == 2
    assert s["files"] == len(wavs) and s["rounds"] == js["rounds"] > 0
    assert s["slot_utilization"] == js["slot_utilization"] and 0.0 < s["slot_utilization"] <= 1.0
    ul = s["utt_latency_s"]
    assert 0 < ul["p50"] <= ul["p95"] <= ul["p99"]


def test_serve_int8_waits_for_a_later_slice(served, monkeypatch, capsys):
    """``--int8`` (port item 9): the W8A8 twin serves each file the JAX
    CLI's int8 tokens."""
    wavs = _wavs(served["dir"], [16000, 20000])
    port, ref = _run_both(served, wavs, ["--int8"], monkeypatch, capsys)
    assert len(port) == 2 and any(r["tokens"] for r in port)
    assert [r["tokens"] for r in port] == [r["tokens"] for r in ref]
    assert [r["times_s"] for r in port] == [r["times_s"] for r in ref]


def test_record_synth_writes_the_root_scripts_samples(tmp_path):
    port_path, root_path = str(tmp_path / "port.wav"), str(tmp_path / "root.wav")
    record.main(["synth", port_path, "--seconds", "2"])
    _root_app("record").synth(root_path, 2)
    got, rate = read_wave(port_path)
    ref, ref_rate = read_wave(root_path)
    assert rate == ref_rate == 16000 and got.shape == (32000,)
    assert np.array_equal(got, ref)
    with open(port_path, "rb") as a, open(root_path, "rb") as b:
        assert a.read() == b.read()


def test_apps_import_no_tkinter_or_pyaudio():
    """Importing the port's serve, record, gui, demo and stream_demo modules
    pulls in neither ``tkinter`` nor ``pyaudio``: they load only when a
    window or an audio device is opened."""
    code = ("import sys\n"
            "from transformer_transducer_tpu_torch.apps import demo, gui, record, serve, "
            "stream_demo\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('tkinter', '_tkinter', "
            "'pyaudio')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_demo_launches_stream_demo_on_the_flagship_config(monkeypatch):
    seen = {}
    monkeypatch.setattr(stream_demo, "main", lambda argv: seen.setdefault("argv", argv))
    demo.main(["--wav", "a.wav", "--device", "cpu"])
    assert seen["argv"] == ["--config", os.path.join(ROOT, "configs", "joint_streaming.yaml"),
                            "--wav", "a.wav", "--device", "cpu"]
