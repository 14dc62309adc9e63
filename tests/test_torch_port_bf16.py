"""PyTorch port: bf16 compute over float32 parameters (``--bf16``) held
against the JAX package at ``compute_dtype=jnp.bfloat16`` on the same
weights (``utils/convert.py``) and the same seeded numpy inputs: the native
encoder (dense unmasked, dense masked, banded, flash), the label encoder, the
joint (concatenated, split, tied), the fused and the pruned loss (tanh and
relu), the espnet encoders and joint, the train step's loss and every
gradient leaf, and the evaluation's greedy decode.  JAX runs as its own
tests run it on the CPU: the banded and flash kernels in Pallas interpret
mode, the pruned loss through its ``additive_logz``.

Each comparison has two conditions:

1. ``max|port - jax_bf16| <= atol + rtol * max|jax_bf16|``, with the
   tolerances stated beside each test;
2. ``||port - jax_bf16|| <= QUARTER * ||jax_bf16 - jax_f32||`` (2-norms
   over the whole tensor): the port sits much nearer JAX's bf16 result than
   bf16 sits from float32, so the rounding points match.  A port that
   computed in float32, or rounded a bias add once where JAX rounds twice,
   sits at about the full distance.

One class of gradient leaves is held differently in condition 2: those JAX
gets as a sum of bf16 cotangents over a broadcast bf16 add (the biases of
the bf16 projections of the encoders, and ``r_w_bias``, ``r_bias``,
``pos_bias_u``, ``pos_bias_v``).  XLA's CPU backend reduces such a sum
with a bf16 accumulator, rounding after every add (its compiled HLO shows
``convert`` to bf16 inside the reduction), where torch sums in float32 and
rounds once.  For them condition 2 reads: the port's leaf is no farther
from JAX's float32 gradient than ``NEAR`` x JAX's bf16 leaf is.  The loss
itself and every other leaf are held to condition 2 as stated.  The espnet
key projection's bias has a gradient of zero in exact arithmetic (a
constant per score row, which the softmax cancels): both packages give
bf16 rounding noise there, so its condition 1 reads: the port's largest
distance from JAX's float32 gradient (the exact zero up to float32
rounding) is at most twice JAX's bf16 one; condition 2 is the reduced
form.

The espnet family's whole-step gradients are held in the reduced form too.
Its layers are pre-LN, with two float32 LayerNorms a layer that flax and
torch compute by different float32 formulas (flax from E[x^2] - E[x]^2);
a float32 difference that moves a value across a bf16 rounding boundary
becomes a whole bf16 step, and the softmax's score path carries it (up to
0.44 of the bf16-to-float32 distance, in ``linear_pos``, measured).  That
the rounding points match is shown there module by module instead
(``test_espnet_modules_vjp_bf16``): each espnet attention and feed-forward,
given the same input and output gradient, gives JAX's bf16 input gradient
and weight gradients to the float32 ulp (bit-equal, measured); the espnet
joint, through the fused loss as the train step runs it, gives every
parameter gradient within ``GRAD_TOL`` and a quarter of the distance; the
native layer, whose post-LN LayerNorms sit inside it, gives its input
gradient to the ulp but for a few elements a bf16 step apart, and its
weights within one bf16 step and a quarter of the distance.  The leaves
that JAX reduces in bf16 (listed above) have no tight check in either
family: every test holds them within ``GRAD_TOL`` and in the reduced form
of condition 2.
"""

import copy
import functools
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.decoding.greedy import greedy_decode as jax_greedy
from transformer_transducer_tpu.models.transducer import build_transducer as jax_build
from transformer_transducer_tpu.ops import rnnt_loss as J
from transformer_transducer_tpu.ops.masks import (
    context_mask as jax_context_mask, look_ahead_mask as jax_look_ahead_mask)
from transformer_transducer_tpu.ops.rnnt_loss_pruned import rnnt_loss_pruned as jax_pruned
from transformer_transducer_tpu.training.train_step import (
    TrainStepConfig as JaxStepConfig, make_loss_fn as jax_make_loss_fn)
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu_torch.decoding.greedy import greedy_decode
from transformer_transducer_tpu_torch.models.espnet_variant import build_espnet_transducer
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops import rnnt_loss as P
from transformer_transducer_tpu_torch.ops.masks import context_mask, look_ahead_mask
from transformer_transducer_tpu_torch.ops.rnnt_loss_pruned import rnnt_loss_pruned
from transformer_transducer_tpu_torch.training.train_step import (
    TrainStepConfig, batch_to_device, make_loss_fn)
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

from torch_port_helpers import (
    bias_blank, jax_espnet_model, t, tiny_espnet_cfg, tiny_model_cfg, to_numpy_tree)

torch.set_num_threads(1)

BF16 = torch.bfloat16
QUARTER = 0.25
NEAR = 1.25
V = 30
# states and logits: within 1e-2 of the tensor's largest magnitude (about
# one bf16 step there) plus 1e-3
STATE_TOL = dict(atol=1e-3, rtol=1e-2)
LOSS_TOL = dict(atol=0.0, rtol=1e-5)
# gradients: within 2.5e-2 of the leaf's largest magnitude (measured: up to
# 1.7e-2, in the bf16-reduced leaves)
GRAD_TOL = dict(atol=0.0, rtol=2.5e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32)


def check(name, got, want_bf16, want_f32, atol, rtol, reduced=False, zero=False):
    """The two conditions of the module docstring (condition 2 in its
    bf16-reduced form with ``reduced``; with ``zero`` the forms of a
    gradient that is zero in exact arithmetic)."""
    got, ref, f32 = _np(got), _np(want_bf16), _np(want_f32)
    assert got.shape == ref.shape == f32.shape, name
    if zero:
        err, bound = np.abs(got - f32).max(), 2 * np.abs(ref - f32).max()
    else:
        err, bound = np.abs(got - ref).max(), atol + rtol * np.abs(ref).max()
    assert err <= bound, f"{name}: max error {err:.3e} over {bound:.3e}"
    dist = np.linalg.norm(ref - f32)
    assert dist > 0, f"{name}: JAX's bf16 equals its float32"
    if reduced:
        mine = np.linalg.norm(got - f32)
        assert mine <= NEAR * dist, \
            f"{name}: {mine:.3e} from float32, JAX's bf16 {dist:.3e}"
    else:
        e2 = np.linalg.norm(got - ref)
        assert e2 <= QUARTER * dist, \
            f"{name}: error {e2:.3e} over a quarter of the bf16-float32 distance {dist:.3e}"


def randomised(variables, seed: int):
    """The flax-initialised tree with every constant leaf (the zero biases,
    the LayerNorms' ones and zeros) replaced by seeded random values, so
    that the biases' rounding points show."""
    rng = np.random.RandomState(seed)

    def fill(x):
        x = np.asarray(x)
        if x.size > 1 and np.all(x == x.flat[0]):
            return (x + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map(fill, variables)


def zero_gradient(name: str) -> bool:
    """Whether the parameter's exact gradient is zero (see the module
    docstring)."""
    return name.endswith(".self_attn.linear_k.bias")


def bf16_reduced(name: str) -> bool:
    """Whether JAX takes this parameter's gradient as a bf16 reduction over
    a broadcast add (see the module docstring)."""
    if name.endswith(("r_w_bias", "r_bias", "pos_bias_u", "pos_bias_v")):
        return True
    return name.endswith(".bias") and any(
        k in name for k in ("CoreNet.", ".self_attn.linear_", ".feed_forward.w_"))


# ---------------------------------------------------------------------------
# the native family's modules
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native():
    """(JAX bf16 model, JAX f32 model, variables, port bf16 model)."""
    cfg = tiny_model_cfg(vocab=V)
    model_f32 = jax_build(JaxConfig(copy.deepcopy(cfg)))
    model_bf16 = jax_build(JaxConfig(copy.deepcopy(cfg)), compute_dtype=jnp.bfloat16)
    variables = randomised(to_numpy_tree(model_f32.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)), jnp.zeros((1, 4), jnp.int32))), 0)
    port = build_transducer(Config(copy.deepcopy(cfg)), device="cpu", compute_dtype=BF16)
    port.load_state_dict(from_jax_params(variables["params"]))
    for p in port.parameters():
        assert p.dtype == torch.float32
    return model_bf16, model_f32, variables, port


@pytest.mark.parametrize("path", ["dense-unmasked", "dense-masked", "banded"])
def test_native_encoder_bf16(native, path):
    """Two layers.  Masked: the streaming context mask through the dense
    branch, whose masked scores are -inf in bf16 (a float32 fill value
    would overflow bf16).  Banded: q, k, v and the tables cast to float32
    before the banded attention, as JAX casts them before its kernel."""
    model_bf16, model_f32, variables, port = native
    x = np.random.RandomState(1).randn(3, 40, 64).astype(np.float32)
    if path == "banded":
        run = lambda m: m.apply(variables, jnp.asarray(x), 10, 2, method="encode_banded")
        got = port.encode_banded(t(x), 10, 2)
    else:
        mask = None if path == "dense-unmasked" else jax_context_mask(40, 10, 2)
        run = lambda m: m.apply(variables, jnp.asarray(x), mask, method="encode")
        got = port.encode(t(x), None if mask is None else context_mask(40, 10, 2))
    assert got.dtype == torch.float32           # the residual stream stays float32
    check(path, got, run(model_bf16), run(model_f32), **STATE_TOL)


def test_native_encoder_bf16_head_width_32():
    """Head width 32 (the tone configs'): the score scale 1/sqrt(32) is not
    a bf16 number, and JAX rounds it to bf16 before the product."""
    cfg = tiny_model_cfg(vocab=V)
    for blk in (cfg["enc"], cfg["dec"]):
        blk.update(n_head=2, d_head=32)
    model_f32 = jax_build(JaxConfig(copy.deepcopy(cfg)))
    model_bf16 = jax_build(JaxConfig(copy.deepcopy(cfg)), compute_dtype=jnp.bfloat16)
    variables = randomised(to_numpy_tree(model_f32.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 64)), jnp.zeros((1, 4), jnp.int32))), 3)
    port = build_transducer(Config(copy.deepcopy(cfg)), device="cpu", compute_dtype=BF16)
    port.load_state_dict(from_jax_params(variables["params"]))
    x = np.random.RandomState(4).randn(2, 30, 64).astype(np.float32)
    run = lambda m: m.apply(variables, jnp.asarray(x), None, method="encode")
    check("head width 32", port.encode(t(x)), run(model_bf16), run(model_f32), **STATE_TOL)


def test_label_encoder_bf16(native):
    """The label encoder under its look-ahead mask (masked scores in bf16)."""
    model_bf16, model_f32, variables, port = native
    tok = np.random.RandomState(2).randint(1, V, (3, 7))
    run = lambda m: m.apply(variables, jnp.asarray(tok), jax_look_ahead_mask(7),
                            method="predict")
    check("label encoder", port.predict(t(tok), look_ahead_mask(7)),
          run(model_bf16), run(model_f32), **STATE_TOL)


def _joint_inputs(seed=3):
    rng = np.random.RandomState(seed)
    return rng.randn(3, 11, 64).astype(np.float32), rng.randn(3, 5, 64).astype(np.float32)


@pytest.mark.parametrize("form", ["concatenated", "split", "rows"])
def test_joint_bf16(native, form):
    """JAX's ``joint_logits`` (one bf16 product over the concatenation)
    against the port's concatenated joint, its split joint (the halves'
    float32 sums of bf16 operands, rounded once) and the decoders' rank-2
    rows."""
    model_bf16, model_f32, variables, port = native
    e, d = _joint_inputs()
    if form == "rows":
        e, d = e[:, 0], d[:, 0]
    run = lambda m: m.apply(variables, jnp.asarray(e), jnp.asarray(d), method="joint_logits")
    joint = port.joint
    if form == "split":
        pre = joint.first_layer(joint.project_enc(t(e))[:, :, None],
                                joint.project_dec(t(d))[:, None])
        got = port.joint_logits_from(pre)
    else:
        got = port.joint_logits(t(e), t(d))
    assert got.dtype == torch.float32
    check(form, got, run(model_bf16), run(model_f32), **STATE_TOL)


def test_tied_joint_bf16():
    """The tied projection: a bf16 product plus the float32 bias (JAX's
    promotion gives float32)."""
    cfg = tiny_model_cfg(vocab=V, share_embedding=True)
    model_f32 = jax_build(JaxConfig(copy.deepcopy(cfg)))
    model_bf16 = jax_build(JaxConfig(copy.deepcopy(cfg)), compute_dtype=jnp.bfloat16)
    variables = randomised(to_numpy_tree(model_f32.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8, 64)), jnp.zeros((1, 4), jnp.int32))), 4)
    port = build_transducer(Config(copy.deepcopy(cfg)), device="cpu", compute_dtype=BF16)
    port.load_state_dict(from_jax_params(variables["params"]))
    e, d = _joint_inputs(5)
    run = lambda m: m.apply(variables, jnp.asarray(e), jnp.asarray(d), method="joint_logits")
    check("tied", port.joint_logits(t(e), t(d)), run(model_bf16), run(model_f32),
          **STATE_TOL)


def test_native_encoder_bf16_flash():
    """Full context through the flash kernels' bf16 forms (their plain
    versions here) against JAX's ``--bf16 --flash`` encoder, whose Pallas
    kernels run in interpret mode: two layers."""
    cfg = tiny_model_cfg(vocab=V)
    model_f32 = jax_build(JaxConfig(copy.deepcopy(cfg)), flash=True)
    model_bf16 = jax_build(JaxConfig(copy.deepcopy(cfg)), flash=True,
                           compute_dtype=jnp.bfloat16)
    variables = randomised(to_numpy_tree(model_f32.init(
        jax.random.PRNGKey(8), jnp.zeros((1, 8, 64)), jnp.zeros((1, 4), jnp.int32))), 8)
    port = build_transducer(Config(copy.deepcopy(cfg)), device="cpu", flash=True,
                            compute_dtype=BF16)
    port.load_state_dict(from_jax_params(variables["params"]))
    x = np.random.RandomState(9).randn(3, 40, 64).astype(np.float32)
    run = lambda m: m.apply(variables, jnp.asarray(x), None, method="encode")
    got = port.encode(t(x))
    assert got.dtype == torch.float32
    check("flash", got, run(model_bf16), run(model_f32), **STATE_TOL)


def test_greedy_evaluation_bf16(native):
    """The evaluation's decode of a bf16 model (bf16 joint, float32 KV label
    cache, as JAX's cache reads the weights): the JAX tokens, from the same
    bf16 encoder states, with the blank biased so that some frames emit."""
    model_bf16, _, variables, _ = native
    biased = bias_blank(variables, -2.0)
    cfg = tiny_model_cfg(vocab=V)
    port = build_transducer(Config(copy.deepcopy(cfg)), device="cpu", compute_dtype=BF16)
    port.load_state_dict(from_jax_params(biased["params"]))
    x = np.random.RandomState(6).randn(3, 30, 64).astype(np.float32)
    t_len = np.array([30, 22, 9])
    enc = model_bf16.apply(biased, jnp.asarray(x), None, method="encode")
    want_tok, want_cnt = jax_greedy(model_bf16, biased, enc, jnp.asarray(t_len), max_tokens=12)
    tok, cnt = greedy_decode(port, t(np.asarray(enc)), t(t_len), max_tokens=12)
    assert np.asarray(want_cnt).min() > 2         # the rows emit
    assert cnt.tolist() == np.asarray(want_cnt).tolist()
    assert tok.tolist() == np.asarray(want_tok).tolist()


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def _loss_problem(seed=5):
    rng = np.random.RandomState(seed)
    b, tlen, u = 3, 13, 4
    return (rng.randn(b, tlen, 64).astype(np.float32), rng.randn(b, u + 1, 64).astype(np.float32),
            rng.randint(1, V, (b, u)), np.array([13, 9, 5]), np.array([4, 3, 1]))


def _joint_params(native):
    variables = native[2]
    jp = tuple(np.asarray(x) for x in J.joint_params_from_variables(variables))
    return jp


@pytest.mark.parametrize("pruned", [False, True], ids=["fused", "pruned"])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_losses_bf16(native, pruned, activation):
    """The loss and its gradients with respect to enc, dec and the five joint
    parameters.  Fused: ``dec_proj`` a bf16 product promoted to float32 by
    ``b1``, the activation and the output product in float32 over
    bf16-rounded ``w_out``.  Pruned: the A grid a bf16 chain, the L grid
    float32, the logZ on float32 grids; the banded joint as the fused one.
    A chunk size (5) that does not divide T (13)."""
    enc, dec, labels, t_len, u_len = _loss_problem()
    jp = _joint_params(native)
    args = (jnp.asarray(labels), jnp.asarray(t_len), jnp.asarray(u_len))
    kw = dict(chunk_size=5, activation=activation)
    if pruned:
        kw.update(s_range=3, simple_scale=0.25)

    def jax_loss(cd):
        fn = jax_pruned if pruned else J.rnnt_loss_fused
        return jax.value_and_grad(
            lambda e, d, p: fn(e, d, p, *args, compute_dtype=cd, **kw),
            argnums=(0, 1, 2))(jnp.asarray(enc), jnp.asarray(dec),
                               tuple(map(jnp.asarray, jp)))

    (l16, g16), (l32, g32) = jax_loss(jnp.bfloat16), jax_loss(jnp.float32)
    e, d = t(enc).requires_grad_(), t(dec).requires_grad_()
    jp_t = [t(x).requires_grad_() for x in jp]
    fn = rnnt_loss_pruned if pruned else P.rnnt_loss_fused
    loss = fn(e, d, jp_t, t(labels), t(t_len), t(u_len), compute_dtype=BF16, **kw)
    grads = torch.autograd.grad(loss, [e, d, *jp_t])
    check("loss", loss, l16, l32, **LOSS_TOL)
    names = ["enc", "dec", "w_enc", "w_dec", "b1", "w_out", "b_out"]
    for name, got, w16, w32 in zip(names, grads, [g16[0], g16[1], *g16[2]],
                                   [g32[0], g32[1], *g32[2]]):
        check(name, got, w16, w32, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the espnet family
# ---------------------------------------------------------------------------

def test_espnet_encoders_and_joint_bf16():
    """The espnet audio encoder on a padded batch (pad masks with fully
    masked padded rows, re-zeroed after the float32 softmax), the
    sos-prefixed text encoder under its band, and the additive joint."""
    cfg = tiny_espnet_cfg(vocab=V)
    model_f32, variables = jax_espnet_model(cfg, seed=1)
    variables = randomised(variables, 1)
    from transformer_transducer_tpu.models.espnet_variant import (
        build_espnet_transducer as jax_build_espnet)
    model_bf16 = jax_build_espnet(JaxConfig(copy.deepcopy(cfg)), compute_dtype=jnp.bfloat16)
    port = build_espnet_transducer(Config(copy.deepcopy(cfg)), device="cpu", compute_dtype=BF16)
    port.load_state_dict(from_jax_params(variables["params"]))
    rng = np.random.RandomState(7)
    x = rng.randn(3, 23, 32).astype(np.float32)
    x_len, text, text_len = np.array([23, 17, 9]), rng.randint(1, V - 1, (3, 5)), np.array([5, 3, 2])
    run = lambda m: m.apply(variables, jnp.asarray(x), jnp.asarray(x_len), jnp.asarray(text),
                            jnp.asarray(text_len), method="encode_both")
    (e16, d16), (e32, d32) = run(model_bf16), run(model_f32)
    enc, dec = port.encode_both(t(x), t(x_len), t(text), t(text_len))
    check("espnet encoder", enc, e16, e32, **STATE_TOL)
    check("espnet text encoder", dec, d16, d32, **STATE_TOL)
    joint = lambda m: m.apply(variables, e16, d16, method="joint_logits")
    check("espnet joint", port.joint_logits(t(np.asarray(e16)), t(np.asarray(d16))),
          joint(model_bf16), joint(model_f32), **STATE_TOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _batch(seed, b=3, tlen=20, u=5, d=64, vocab=V):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(b, tlen, d).astype(np.float32),
            "inputs_length": np.array([tlen] + list(rng.randint(8, tlen + 1, b - 1))),
            "targets": rng.randint(1, vocab - 1, (b, u)),
            "targets_length": np.array([u] + list(rng.randint(1, u + 1, b - 1)))}


@pytest.mark.parametrize("kind,pruned", [("dense", None), ("banded", None),
                                         ("banded", 3), ("flash", None), ("espnet", None)])
def test_train_step_loss_and_every_gradient_bf16(kind, pruned):
    """``make_loss_fn`` of both packages (SpecAugment off, dropout 0): the
    loss and the gradient of every parameter, mapped into the port's names
    (``from_jax_params``)."""
    if kind == "espnet":
        cfg = tiny_espnet_cfg(vocab=V)
        jax_f32, variables = jax_espnet_model(cfg, seed=2)
        variables = randomised(variables, 2)
        from transformer_transducer_tpu.models.espnet_variant import (
            build_espnet_transducer as jax_build_espnet)
        models = {cd: jax_build_espnet(JaxConfig(copy.deepcopy(cfg)), compute_dtype=cd)
                  for cd in (jnp.bfloat16, jnp.float32)}
        port = build_espnet_transducer(Config(copy.deepcopy(cfg)), device="cpu",
                                       compute_dtype=BF16)
        batch = _batch(8, d=32)
    else:
        cfg = tiny_model_cfg(vocab=V)
        models = {cd: jax_build(JaxConfig(copy.deepcopy(cfg)), compute_dtype=cd,
                                banded=kind == "banded", flash=kind == "flash")
                  for cd in (jnp.bfloat16, jnp.float32)}
        variables = randomised(to_numpy_tree(models[jnp.float32].init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)), jnp.zeros((1, 4), jnp.int32))), 5)
        port = build_transducer(Config(copy.deepcopy(cfg)), device="cpu",
                                banded=kind == "banded", flash=kind == "flash",
                                compute_dtype=BF16)
        batch = _batch(7)
    port.load_state_dict(from_jax_params(variables["params"]))
    port.train()
    out = {}
    for cd, model in models.items():
        fn = jax_make_loss_fn(model, JaxStepConfig(specaug=False, compute_dtype=cd,
                                                   loss_pruned_range=pruned))
        out[cd] = jax.value_and_grad(fn)(variables["params"],
                                         {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(0))
    loss = make_loss_fn(port, TrainStepConfig(specaug=False, loss_pruned_range=pruned))(
        batch_to_device(batch, "cpu"), None)
    loss.backward()
    (l16, g16), (l32, g32) = out[jnp.bfloat16], out[jnp.float32]
    check("loss", loss, l16, l32, **LOSS_TOL)
    want16, want32 = from_jax_params(g16), from_jax_params(g32)
    names = [n for n, _ in port.named_parameters()]
    assert set(names) == set(want16)
    for name, p in port.named_parameters():
        check(name, p.grad, want16[name], want32[name], **GRAD_TOL,
              reduced=kind == "espnet" or bf16_reduced(name) or zero_gradient(name),
              zero=zero_gradient(name))


def _module_vjp(make, tree, path, model, module, port_fn, xs, ct):
    """Gradients of ``sum(f(*xs) * ct)`` with respect to the inputs and the
    parameters of one module: the port's (``port_fn`` over ``module`` of
    ``model``) and JAX's at bf16 and at float32 (``make(cd)(params, *xs)``
    over the subtree at ``path`` of the params ``tree``), JAX's leaves put
    back into the whole tree and named by ``from_jax_params``.  Returns
    ``(port, jax_bf16, jax_f32)``, each ``(input gradients, {name: grad})``
    with the parameters' names in the model."""
    prefix = next(n for n, m in model.named_modules() if m is module) + "."
    sub = functools.reduce(operator.getitem, path, tree)
    out = []
    for cd in (jnp.bfloat16, jnp.float32):
        _, vjp = jax.vjp(make(cd), sub, *map(jnp.asarray, xs))
        g_sub, *g_x = vjp(jnp.asarray(ct))
        leaves = {tuple(k.key for k in kp): v
                  for kp, v in jax.tree_util.tree_flatten_with_path(g_sub)[0]}

        def put(kp, leaf):
            key = tuple(k.key for k in kp)
            inside = key[:len(path)] == path
            return np.asarray(leaves[key[len(path):]]) if inside else np.zeros_like(leaf)
        state = from_jax_params(jax.tree_util.tree_map_with_path(put, tree))
        out.append(([np.asarray(g) for g in g_x],
                    {n: v for n, v in state.items() if n.startswith(prefix)}))
    module.zero_grad()
    xts = [t(x).requires_grad_() for x in xs]
    (port_fn(*xts) * t(ct)).sum().backward()
    got = {prefix + n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(out[0][1])
    return ([x.grad for x in xts], got), out[0], out[1]


def _bias_add(name: str) -> bool:
    """Whether the parameter is added in bf16 over a broadcast (a bias of a
    bf16 projection, a position bias), so that JAX reduces its gradient
    with a bf16 accumulator; the LayerNorms' float32 biases are not."""
    return (name.endswith(("r_w_bias", "r_bias", "pos_bias_u", "pos_bias_v"))
            or name.endswith(".bias") and "layer_norm" not in name)


def _hold_module(what, port, bf16, f32, weight_tol):
    """The input gradients to the float32 ulp; each weight within
    ``weight_tol`` and a quarter of the distance; a bias added over a
    broadcast within ``GRAD_TOL`` and the reduced form; the espnet key bias
    in the zero form (module docstring)."""
    for i, (got, want) in enumerate(zip(port[0], bf16[0])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=f"{what} input {i}")
    for name, grad in port[1].items():
        if _bias_add(name):
            check(name, grad, bf16[1][name], f32[1][name], **GRAD_TOL, reduced=True,
                  zero=zero_gradient(name))
        else:
            check(name, grad, bf16[1][name], f32[1][name], **weight_tol)


def test_espnet_modules_vjp_bf16():
    """Each bf16 module alone, given the same input and output gradient.
    The espnet attention (under a band and pad mask, fully masked padded
    rows included), feed-forward and joint (on rank-2 rows, as the decoders
    call it) give JAX's bf16 input gradients and weight gradients to the
    float32 ulp (bit-equal, measured): the backward rounds where JAX's does
    (one cast of the input shared by the q, k, v products, the division by
    the bf16-rounded sqrt(d_k), bf16 bias adds).  The native layer, whose
    post-LN float32 LayerNorms sit inside it, gives its input gradient to
    the ulp but for at most 0.5 % of the elements, and its weights,
    ``r_emb`` and LayerNorm parameters within one bf16 step of the leaf's
    largest magnitude (measured: 3.7e-3 of it, in ``qkv_net``).  The
    biases added over a broadcast are held in the reduced form only."""
    from transformer_transducer_tpu.models.attention import TransformerXLLayer as JaxLayer
    from transformer_transducer_tpu.models.espnet_variant import (
        EspnetFeedForward as JaxFF, RelPosMultiHeadAttention as JaxAttn,
        joint_params_from_espnet_variables, rel_positional_encoding)
    from transformer_transducer_tpu.ops.masks import combine_masks, padding_mask
    cfg = tiny_espnet_cfg(vocab=V)
    _, variables = jax_espnet_model(cfg, seed=6)
    tree = randomised(variables, 6)["params"]
    port = build_espnet_transducer(Config(copy.deepcopy(cfg)), device="cpu", compute_dtype=BF16)
    port.load_state_dict(from_jax_params(tree))
    rng = np.random.RandomState(9)
    x, ct = rng.randn(3, 20, 32).astype(np.float32), rng.randn(3, 20, 32).astype(np.float32)
    pos = rel_positional_encoding(20, 32)
    mask = combine_masks(jax_context_mask(20, 3, 2)[None],
                         padding_mask(jnp.asarray([20, 13, 7]), 20)[:, None, :])
    exact = dict(atol=1e-6, rtol=0.0)
    attn = port.encoder.encoders[1].self_attn
    _hold_module("espnet attention", *_module_vjp(
        lambda cd: lambda p, h: JaxAttn(n_head=4, d_model=32, compute_dtype=cd).apply(
            {"params": p}, h, jnp.asarray(pos), mask),
        tree, ("encoder", "layer_1", "self_attn"), port, attn,
        lambda h: attn(h, t(pos), t(np.asarray(mask))), [x], ct), exact)
    ff = port.encoder.encoders[1].feed_forward
    _hold_module("espnet feed-forward", *_module_vjp(
        lambda cd: lambda p, h: JaxFF(d_model=32, d_inner=64, compute_dtype=cd).apply(
            {"params": p}, h),
        tree, ("encoder", "layer_1", "feed_forward"), port, ff, ff, [x], ct), exact)
    # the joint as the train step runs it: through the fused loss, whose
    # biases are float32 adds (no bf16 reduction), every leaf at condition 2
    enc, dec, labels, t_len, u_len = _loss_problem()
    enc, dec = enc[..., :32], dec[..., :32]
    port_g, bf16_g, f32_g = _module_vjp(
        lambda cd: lambda p, e, d: J.rnnt_loss_fused(
            e, d, joint_params_from_espnet_variables({"joint": p}), jnp.asarray(labels),
            jnp.asarray(t_len), jnp.asarray(u_len), chunk_size=5, compute_dtype=cd),
        tree, ("joint",), port, port.joint,
        lambda e, d: P.rnnt_loss_fused(e, d, port.joint_params(), t(labels), t(t_len),
                                       t(u_len), chunk_size=5, compute_dtype=BF16),
        [enc, dec], np.float32(1.0))
    for i, (got, w16, w32) in enumerate(zip(port_g[0], bf16_g[0], f32_g[0])):
        check(f"espnet joint input {i}", got, w16, w32, **GRAD_TOL)
    for name, grad in port_g[1].items():
        check(name, grad, bf16_g[1][name], f32_g[1][name], **GRAD_TOL)

    native_cfg = tiny_model_cfg(vocab=V)
    model = jax_build(JaxConfig(copy.deepcopy(native_cfg)))
    ntree = randomised(to_numpy_tree(model.init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8, 64)), jnp.zeros((1, 4), jnp.int32))), 7)["params"]
    nport = build_transducer(Config(copy.deepcopy(native_cfg)), device="cpu", compute_dtype=BF16)
    nport.load_state_dict(from_jax_params(ntree))
    x, ct = rng.randn(2, 24, 64).astype(np.float32), rng.randn(2, 24, 64).astype(np.float32)
    layer = nport.encoder.layers[0]
    port_g, bf16_g, f32_g = _module_vjp(
        lambda cd: lambda p, h: JaxLayer(k_len=120, n_head=4, d_model=64, d_head=16,
                                         d_inner=128, compute_dtype=cd).apply(
            {"params": p}, h, jax_context_mask(24, 10, 2)),
        ntree, ("encoder", "layer_0"), nport, layer,
        lambda h: layer(h, context_mask(24, 10, 2)), [x], ct)
    # the native layer ends in its float32 LayerNorms (post-LN): a float32
    # difference there can move a value across a bf16 rounding boundary,
    # so a few elements may differ, each by about one bf16 step at the
    # gradient's scale
    got, want = port_g[0][0].numpy(), bf16_g[0][0]
    diff = np.abs(got - want)
    off = diff > 1e-6
    assert off.mean() <= 5e-3, f"{off.sum()} of {off.size} elements differ"
    assert diff.max() <= 2.0 ** -7 * np.abs(want).max()
    _hold_module("native layer", (port_g[0][:0], port_g[1]), bf16_g, f32_g,
                 dict(atol=0.0, rtol=2.0 ** -7))
