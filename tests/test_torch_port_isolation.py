"""PyTorch port: the package and ``chip_smoke.py`` import no JAX, no flax and
nothing of the JAX package, and entry points never fall back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "transformer_transducer_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transformer_transducer_tpu")

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
    from transformer_transducer_tpu_torch.apps import predict, stream_demo, train
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession, TrapezoidStreamingSession)
    from transformer_transducer_tpu_torch.utils.config import Config
    from transformer_transducer_tpu_torch.utils.device import resolve_device
    from torch_port_helpers import tiny_model_cfg

    model = build_transducer(Config(tiny_model_cfg()), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for session, kw in ((StreamingSession, {}), (StreamingSession, {"incremental": True}),
                        (TrapezoidStreamingSession, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            session(model, StreamingConfig(n_layer=2, feature_dim=16), **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_demo.main(["--config", "x.yaml", "--wav", "a.wav"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_transducer(Config(tiny_model_cfg()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict.main(["--config", "x.yaml", "--checkpoint", "m.pt",
                      "--wav", "a.wav"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["-config", os.path.join(ROOT, "configs", "joint_streaming.yaml")])
    assert resolve_device("cpu").type == "cpu"


def test_espnet_family_waits_for_a_later_slice():
    from transformer_transducer_tpu_torch.models.factory import build_family
    from transformer_transducer_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(ROOT, "configs", "espnet_aishell.yaml"))
    with pytest.raises(NotImplementedError, match="later slice"):
        build_family(cfg, 512, device="cpu")
