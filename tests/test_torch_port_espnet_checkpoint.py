"""PyTorch port: the espnet family's checkpoints and the predict CLI — a
JAX espnet checkpoint, float and int8-baked, read by ``load_family`` leaf
for leaf, the port's own checkpoints and quantise tool, and
``apps/predict.py`` (greedy, ``--beam``, ``--int8``) on an espnet config
against the root JAX CLI's text on the same checkpoint.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu_torch.apps import predict as predict_app
from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.models import espnet_variant as ev
from transformer_transducer_tpu_torch.models.factory import load_family
from transformer_transducer_tpu_torch.tools import quantize_checkpoint
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.convert import COMPONENTS, from_jax_params

from torch_port_helpers import espnet_train_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng(seed):
    return np.random.default_rng(seed)


def _root_module(folder, name):
    spec = importlib.util.spec_from_file_location(f"ttx_root_{folder}_{name}",
                                                  os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """An espnet config and vocabulary, a float JAX espnet checkpoint and
    the JAX package's int8-baked copy of it."""
    from transformer_transducer_tpu.models.factory import build_family
    from transformer_transducer_tpu.utils import checkpoint as jax_ckpt
    from transformer_transducer_tpu.utils.config import Config as JaxConfig, dump_config
    tmp = tmp_path_factory.mktemp("espnet")
    vocab = tmp / "vocab.txt"
    vocab.write_text("<b> 0\n" + "".join(f"w{i} {i}\n" for i in range(1, 12)))
    cfg = JaxConfig(espnet_train_config(str(tmp), str(vocab),
                                        {"train": "x", "dev": "x", "test": "x"}))
    dump_config(cfg, str(tmp / "cfg.yaml"))
    model, variables, is_esp = build_family(cfg, 16)
    assert is_esp
    x = _rng(0).standard_normal((1, 40, 16)).astype(np.float32)
    enc = model.apply(variables, jnp.asarray(x), method="encode")
    dec = model.apply(variables, jnp.asarray([[11]]), method="predict")
    logits = np.asarray(model.apply(variables, enc, dec, method="joint_logits"))[0, :, 0]
    margin = logits[:, 1:].max(-1) - logits[:, 0]
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["joint"]["lin_out"]["bias"][0] += float(np.quantile(margin, 0.6))
    float_dir = jax_ckpt.save_checkpoint(str(tmp / "float"), params, epoch=3, step=77)
    _root_module("tools", "quantize_checkpoint").main([float_dir, str(tmp / "int8")])
    return {"dir": tmp, "cfg": str(tmp / "cfg.yaml"), "float": float_dir,
            "int8": str(tmp / "int8"), "params": params}


def _port_cfg(served):
    from transformer_transducer_tpu_torch.utils.config import load_config
    return load_config(served["cfg"])


def _same_tensors(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


def test_jax_checkpoints_load_to_the_bit(served):
    """A JAX espnet checkpoint, float and int8-baked, reads into the port's
    espnet model leaf for leaf; ``--int8`` on the float one equals the
    baked one; the port's own tool bakes the same tensors."""
    from flax import serialization
    cfg = _port_cfg(served)
    model = load_family(cfg, 16, served["float"], device="cpu")
    assert isinstance(model, ev.EspnetTransducer) and not model.quant
    _same_tensors(model.state_dict(), from_jax_params(served["params"]))
    baked = load_family(cfg, 16, served["int8"], device="cpu")
    assert baked.quant
    tree = {}
    for comp in COMPONENTS:
        with open(os.path.join(served["int8"], f"{comp}.msgpack"), "rb") as fh:
            tree[comp] = serialization.msgpack_restore(fh.read())
    _same_tensors(baked.state_dict(), from_jax_params(tree))
    _same_tensors(load_family(cfg, 16, served["float"], device="cpu", int8=True).state_dict(),
                  baked.state_dict())
    out = served["dir"] / "port_int8"
    quantize_checkpoint.main([served["float"], str(out), "--device", "cpu"])
    _same_tensors(load_family(cfg, 16, str(out), device="cpu").state_dict(),
                  baked.state_dict())
    # the port's own checkpoint round trip
    path = ckpt_lib.save_checkpoint(str(served["dir"] / "port" / "epoch_3"), model, epoch=3)
    _same_tensors(load_family(cfg, 16, path, device="cpu").state_dict(), model.state_dict())


def _wav(directory, n=24000):
    rng = np.random.RandomState(0)
    path = str(directory / f"a{n}.wav")
    write_wave(path, np.sin(np.arange(n) * 0.02) * 9000 + rng.randn(n) * 1500)
    return path


@pytest.mark.parametrize("ckpt,flags", [
    ("float", []), ("float", ["--beam"]), ("float", ["--int8"]), ("float", ["--full-context"]),
    ("int8", ["--beam"])])
def test_predict_cli_matches_the_jax_cli(served, monkeypatch, capsys, ckpt, flags):
    """``apps/predict.py`` on an espnet config against the root JAX CLI's
    text on the same JAX checkpoint (greedy, beam, int8; the int8-baked
    one is served int8 without the flag; ``--full-context`` does not apply
    to the family)."""
    argv = ["--config", served["cfg"], "--checkpoint", served[ckpt],
            "--wav", _wav(served["dir"]), *flags]
    text = predict_app.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["predict.py", *argv])
    _root_module("apps", "predict").main()
    assert text and f"prediction: {text}\n" in capsys.readouterr().out
