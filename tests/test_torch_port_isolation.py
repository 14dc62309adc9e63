"""PyTorch port: the package and ``chip_smoke.py`` import no JAX, no flax,
no optax, no msgpack (the card's machine has none of them) and nothing of
the JAX package, and entry points never fall back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "transformer_transducer_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "transformer_transducer_tpu")

torch.set_num_threads(1)


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _modules():
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        if rel.startswith("transformer_transducer_tpu_torch"):
            mod = rel[:-3].replace(os.sep, ".")
            yield mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def test_source_scan_finds_no_jax_import():
    bad = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_importing_every_module_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"mods = {sorted(_modules())!r}\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(len(mods), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def test_entry_points_raise_without_cuda(monkeypatch):
    from transformer_transducer_tpu_torch.apps import predict, serve, stream_demo, train
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.streaming.batched import BatchedStreamingSession
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession, TrapezoidStreamingSession)
    from transformer_transducer_tpu_torch.tools import quantize_checkpoint
    from transformer_transducer_tpu_torch.utils.config import Config
    from transformer_transducer_tpu_torch.utils.device import resolve_device
    from torch_port_helpers import tiny_model_cfg

    model = build_transducer(Config(tiny_model_cfg()), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for session, kw in ((StreamingSession, {}), (StreamingSession, {"incremental": True}),
                        (TrapezoidStreamingSession, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            session(model, StreamingConfig(n_layer=2, feature_dim=16), **kw)
    for incremental in (False, True):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchedStreamingSession(model, StreamingConfig(n_layer=2, feature_dim=16), 2,
                                    incremental=incremental)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_demo.main(["--config", "x.yaml", "--wav", "a.wav"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--config", "x.yaml", "--checkpoint", "m.pt", "--wavs", "a.wav"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_transducer(Config(tiny_model_cfg()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict.main(["--config", "x.yaml", "--checkpoint", "m.pt",
                      "--wav", "a.wav"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["-config", os.path.join(ROOT, "configs", "joint_streaming.yaml")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_checkpoint.main(["model.pt", "out"])
    assert resolve_device("cpu").type == "cpu"


def test_espnet_family_waits_for_a_later_slice():
    from transformer_transducer_tpu_torch.models.factory import build_family
    from transformer_transducer_tpu_torch.utils.config import load_config
    from transformer_transducer_tpu_torch.models.espnet_variant import EspnetTransducer
    cfg = load_config(os.path.join(ROOT, "configs", "espnet_aishell.yaml"))
    # the family is built now, on the device asked for; without a card
    # its entry points raise like the native family's
    model = build_family(cfg, 512, device="cpu")
    assert isinstance(model, EspnetTransducer) and not model.training
    assert sum(p.numel() for p in model.parameters()) == 23277193
    with pytest.raises(ValueError, match="input width"):
        build_family(cfg, 128, device="cpu")


def test_espnet_modules_are_scanned_and_their_entry_points_raise_without_cuda(monkeypatch):
    """The espnet family's modules are among those scanned above, and its
    entry points take the card unless asked for the CPU."""
    from transformer_transducer_tpu_torch.apps import train_esptt
    from transformer_transducer_tpu_torch.models.espnet_variant import build_espnet_transducer
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession)
    from transformer_transducer_tpu_torch.utils.config import Config
    from torch_port_helpers import tiny_espnet_cfg
    mods = set(_modules())
    for mod in ("models.espnet_variant", "decoding.espnet_label_cache", "apps.train_esptt"):
        assert "transformer_transducer_tpu_torch." + mod in mods
    cfg = Config(tiny_espnet_cfg())
    model = build_espnet_transducer(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_espnet_transducer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingSession(model, StreamingConfig(n_layer=2, feature_dim=8, left_context=3,
                                                seed_token=39))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_esptt.main(["-config", os.path.join(ROOT, "configs", "espnet_aishell.yaml")])


def test_tone_corpus_writer_is_scanned_and_bf16_training_raises_without_cuda(monkeypatch):
    """The port's ``tools/tone_demo.py`` (the corpus of the learning runs) is
    among the modules scanned above, and ``--bf16`` / ``--remat`` training
    takes the card unless asked for the CPU, as the float training does."""
    from transformer_transducer_tpu_torch.apps import train
    assert "transformer_transducer_tpu_torch.tools.tone_demo" in set(_modules())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["-config", os.path.join(ROOT, "configs", "joint_streaming.yaml"),
                    "--bf16", "--remat"])


def test_host_runtime_and_tools_are_scanned_and_raise_without_cuda(monkeypatch):
    """The native runtime, the VAD, corpus prep and the checkpoint and plot
    tools are among the modules scanned above (the C++ source is no Python
    module: ``runtime/native.py`` builds it with g++, not with nvcc), and
    the checkpoint tools take the card unless asked for the CPU."""
    from transformer_transducer_tpu_torch.tools import average_checkpoints, convert_checkpoint
    mods = set(_modules())
    for mod in ("runtime.native", "ops.vad", "ops.misc", "data.prep",
                "tools.average_checkpoints", "tools.convert_checkpoint",
                "tools.plot_training", "tools.plot_features", "tools.tone_demo"):
        assert "transformer_transducer_tpu_torch." + mod in mods
    assert os.path.exists(os.path.join(PKG, "csrc", "ttx_runtime.cc"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        average_checkpoints.main(["--checkpoints", "a", "b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_checkpoint.main(["ref.chkpt", "out"])
