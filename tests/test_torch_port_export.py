"""PyTorch port: kernels 8 and 9 as ``torch.library`` ops
(``ops/cuda/flash_rel_attention.py``) and the export of the inference
components (``runtime/export.py``); mirrors ``test_export_roundtrip`` of
``tests/test_export_vad.py``.

The ops pass ``torch.library.opcheck`` in float32 and bf16; on the CPU a
gradient through them is autograd's through the plain version, to the
bit; tracing them under fake tensors (CUDA ones too) launches and counts
nothing.  The exported programs, reloaded in this process and in a fresh
one, equal the live port model (rtol 1e-5, atol 1e-6) and the JAX
package's exported StableHLO on the same weights (rtol 2e-4, atol 2e-5);
a ``flash=True`` encoder's program holds one op node a layer, fed the
strided views of the fused projection.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.runtime import export as jax_export
from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
from transformer_transducer_tpu_torch.ops.masks import context_mask, look_ahead_mask
from transformer_transducer_tpu_torch.runtime.export import (
    export_transducer, load_exported, model_dim)

from torch_port_helpers import jax_model, port_model, tiny_model_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
V = 50
FRAMES, TOKENS, D = 24, 8, 64
LEFT, RIGHT = 3, 1
LIVE_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
COMPONENTS = ("encoder", "encoder_streaming", "decoder", "joint")


def _leaves(dtype, b=2, t=9, h=4, dh=16, seed=0):
    """q, k, v as strided views of one fused projection, and the tables."""
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: (torch.randn(*s, generator=gen) * 0.5).to(dtype).requires_grad_()
    qkv, r_emb, u, rb = mk(b, t, 3, h, dh), mk(t, h, dh), mk(h, dh), mk(t, h)
    gout = torch.randn(b, t, h, dh, generator=gen)
    return [qkv, r_emb, u, rb], gout


def _args(leaves):
    qkv, r_emb, u, rb = leaves
    return (*qkv.unbind(2), r_emb, u, rb)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("op", ["fwd", "bwd"])
def test_ops_pass_opcheck(op, dtype):
    leaves, gout = _leaves(dtype)
    args = _args(leaves)
    if op == "fwd":
        for with_lse in (True, False):
            torch.library.opcheck(torch.ops.ttx.flash_rel_attention_fwd.default,
                                  (*args, with_lse))
        return
    plain = [x.detach() for x in args]
    out, lse, sums = torch.ops.ttx.flash_rel_attention_fwd(*plain, True)
    torch.library.opcheck(torch.ops.ttx.flash_rel_attention_bwd.default,
                          (*plain, sums if dtype == BF16 else out, lse, gout))


def _grads(fn, leaves, gout):
    for x in leaves:
        x.grad = None
    out = fn(*_args(leaves))
    (out.reshape(out.shape[0], out.shape[1], -1) * gout.reshape(out.shape[0], out.shape[1], -1)
     ).sum().backward()
    return [out.detach()] + [x.grad.clone() for x in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
def test_cpu_gradients_through_the_op_are_the_plain_versions(dtype):
    """Through the ops (the wrapper) and through the plain version (autograd
    for float32, the written-out bf16 backward): outputs and gradients equal
    to the bit, and no launch counted."""
    leaves, gout = _leaves(dtype, seed=1)
    before = fa.flash_rel_attention.launches, fa.flash_rel_attention_backward.launches
    got = _grads(fa.flash_rel_attention, leaves, gout)
    want = _grads(fa.flash_rel_attention_plain, leaves, gout)
    for name, a, b in zip(("out", "qkv", "r_emb", "r_w_bias", "r_bias"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert (fa.flash_rel_attention.launches,
            fa.flash_rel_attention_backward.launches) == before


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
def test_tracing_under_fake_tensors_counts_nothing(device, dtype):
    """The forward through the wrapper and the backward op on fake tensors
    (CUDA ones too, with no card; on the CPU also autograd's backward): the
    fake implementations give the real shapes, dtypes and strides, and no
    counter moves."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    names = ("flash_rel_attention", "flash_rel_attention_backward",
             "flash_forward_bf16", "flash_backward_bf16")
    before = [getattr(fa, n).launches for n in names]
    with FakeTensorMode():
        # autograd's graph on CUDA tensors needs a CUDA build: gradients on
        # the CPU alone
        leaves = [torch.randn(x.shape, dtype=dtype, device=device).requires_grad_(
            device == "cpu") for x in _leaves(dtype)[0]]
        args = _args(leaves)
        out = fa.flash_rel_attention(*args)
        assert out.shape == args[0].shape and out.dtype == torch.float32
        assert out.is_contiguous() and out.device.type == device
        plain = [x.detach() for x in args]
        out, lse, sums = torch.ops.ttx.flash_rel_attention_fwd(*plain, True)
        # the row statistics are kept on the card; the CPU backward recomputes
        keep = device == "cuda"
        assert lse.shape == ((2, 4, 9) if keep else (0,))
        assert sums.shape == ((2, 9, 4, 16) if keep and dtype == BF16 else (0,))
        grads = torch.ops.ttx.flash_rel_attention_bwd(
            *plain, sums if dtype == BF16 else out, lse, torch.randn_like(out))
        assert [(g.shape, g.dtype, g.is_contiguous()) for g in grads] == [
            (x.shape, dtype, True) for x in plain]
        if device == "cpu":
            fa.flash_rel_attention(*args).sum().backward()
            assert [x.grad.dtype for x in leaves] == [dtype] * 4
    assert [getattr(fa, n).launches for n in names] == before


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny flash model (JAX's weights) exported by the port, and the
    JAX package's export of the same weights."""
    cfg = tiny_model_cfg(vocab=V)
    model_j, variables = jax_model(cfg)
    model = port_model(cfg, variables, flash=True)
    root = tmp_path_factory.mktemp("export")
    kw = dict(max_frames=FRAMES, max_tokens=TOKENS, d_in=D, left_context=LEFT,
              right_context=RIGHT)
    paths = export_transducer(model, str(root / "port"), **kw)
    jax_paths = jax_export.export_transducer(model_j, variables, str(root / "jax"), **kw)
    rng = np.random.RandomState(0)
    inputs = {"encoder": (rng.randn(1, FRAMES, D).astype(np.float32),),
              "decoder": (rng.randint(1, V, (1, TOKENS)),),
              "joint": (rng.randn(1, D).astype(np.float32),
                        rng.randn(1, D).astype(np.float32))}
    inputs["encoder_streaming"] = inputs["encoder"]
    return model, model_j, variables, paths, jax_paths, inputs, root


def _live(model, name, args):
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in args]
        if name == "encoder":
            return model.encode(t[0])
        if name == "encoder_streaming":
            return model.encode(t[0], context_mask(FRAMES, LEFT, RIGHT))
        if name == "decoder":
            return model.predict(t[0], look_ahead_mask(TOKENS))
        return model.joint_logits(*t)


def test_export_writes_the_four_components(exported):
    model, model_j, variables, paths, jax_paths, _, _ = exported
    assert set(paths) == set(jax_paths) == set(COMPONENTS)
    assert all(p.endswith(".pt2") and os.path.exists(p) for p in paths.values())
    assert model_dim(model) == jax_export.model_dim(model_j, variables) == D
    assert not model.training


@pytest.mark.parametrize("name", COMPONENTS)
def test_reloaded_program_matches_the_live_model(exported, name):
    model, _, _, paths, _, inputs, _ = exported
    program = load_exported(paths[name])
    with torch.no_grad():
        got = program(*[torch.from_numpy(a) for a in inputs[name]])
    np.testing.assert_allclose(got.numpy(), _live(model, name, inputs[name]).numpy(),
                               **LIVE_TOL)


@pytest.mark.parametrize("name", COMPONENTS)
def test_program_matches_the_jax_export(exported, name):
    """The port's program against JAX's StableHLO of the same weights."""
    _, _, _, paths, jax_paths, inputs, _ = exported
    with torch.no_grad():
        got = load_exported(paths[name])(*[torch.from_numpy(a) for a in inputs[name]])
    args = [jnp.asarray(a.astype(np.int32) if a.dtype.kind == "i" else a)
            for a in inputs[name]]
    want = np.asarray(jax_export.load_exported(jax_paths[name])(*args))
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


def test_programs_run_in_a_fresh_process(exported):
    """A new interpreter (the port alone, no JAX) loads the four programs
    and runs them on the same inputs: the live model's results."""
    model, _, _, paths, _, inputs, root = exported
    np.savez(str(root / "inputs.npz"), **{f"{n}_{i}": a for n in COMPONENTS
                                          for i, a in enumerate(inputs[n])})
    script = """
import json, sys, numpy as np, torch
from transformer_transducer_tpu_torch.runtime.export import load_exported
paths, root = json.loads(sys.argv[1]), sys.argv[2]
data = np.load(root + "/inputs.npz")
out = {}
with torch.no_grad():
    for name, path in paths.items():
        args = [torch.from_numpy(data[k]) for k in sorted(data.files)
                if k.rsplit("_", 1)[0] == name]
        out[name] = load_exported(path)(*args).numpy()
np.savez(root + "/outputs.npz", **out)
print("jax" in sys.modules)
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", script, json.dumps(paths), str(root)],
                         env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.strip().splitlines()[-1] == "False"
    got = np.load(str(root / "outputs.npz"))
    for name in COMPONENTS:
        np.testing.assert_allclose(got[name], _live(model, name, inputs[name]).numpy(),
                                   err_msg=name, **LIVE_TOL)


def test_flash_encoder_program_holds_one_op_a_layer(exported):
    """The full-context encoder's graph: one ``ttx::flash_rel_attention_fwd``
    node a layer (without the row statistics), each fed q, k, v straight
    from the ``unbind`` of the fused projection (no copy between); the
    streaming encoder runs the masked dense branch, with no such node."""
    model, _, _, paths, _, _, _ = exported
    op = torch.ops.ttx.flash_rel_attention_fwd.default

    def op_nodes(name):
        graph = torch.export.load(paths[name]).graph
        return [n for n in graph.nodes if n.op == "call_function" and n.target is op]
    nodes = op_nodes("encoder")
    assert len(nodes) == len(model.encoder.layers) == 2
    for node in nodes:
        assert node.args[-1] is False
        for arg in node.args[:3]:
            assert arg.target.__name__ == "getitem"
            assert arg.args[0].target is torch.ops.aten.unbind.int
    assert op_nodes("encoder_streaming") == []
