"""PyTorch port: the bf16 forms of the flash rel-position attention
(``ops/cuda/flash_rel_attention.py``), held against the JAX package's
``flash_rel_attention`` on bf16 inputs, its Pallas kernels in interpret
mode, on the same numpy inputs rounded to bf16.

The plain bf16 forward (``flash_bf16_forward_plain``) and the written-out
backward (``flash_bf16_backward_plain``) round where the Pallas kernels
round: ``q + u`` in bf16, the scores divided by sqrt(Dh) in float32, P
rounded to bf16 before P.V; dO rounded to bf16, D_i from the float32 P,
dS and P rounded to bf16 before every product, the gradients cast to bf16.

Each comparison has three conditions, at Dh 16, 32 and 64 and at lengths on
both sides of the kernels' query tiles and key chunks:

1. the output within ``FWD_RTOL`` of its largest magnitude, plus one bf16
   step of the row's largest probability times the largest |v|: a P whose
   float32 value lies within a few ulps of a bf16 rounding boundary may
   round the other way in another summation order, and moves its row by
   that much (measured: without the allowance, at inputs of half this
   scale, the output of 8 of the 24 (Dh, T) cases missed the bar);
2. each gradient within ``GRAD_RTOL`` of its leaf's largest magnitude, or
   one bf16 step of the element: the gradients are cast to bf16 at the end,
   and a float32 value at a rounding boundary lands one step away;
3. the output's and each gradient's 2-norm error within a quarter of JAX's
   own distance between its bf16 and its float32 result on the same
   bf16-valued inputs: the rounding points match, and the roundings that
   went the other way in 1 and 2 are few.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops.pallas.flash_rel_attention import (
    flash_rel_attention as jax_flash)
from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa

from torch_port_helpers import bf16_step, flip_allowance, hold_bf16, t

torch.set_num_threads(1)

FWD_RTOL = 2e-4
GRAD_RTOL = 2e-3
QUARTER = 0.25
T_VALUES = [1, 31, 32, 33, 127, 128, 129, 150]
HEAD_DIMS = [16, 32, 64]
NAMES = ("dq", "dk", "dv", "d r_emb", "d r_w_bias", "d r_bias")


def _inputs(dh, tlen, seed):
    """q, k, v, r_emb, r_w_bias, r_bias and the output gradient, the six
    inputs rounded to bf16 (float32 arrays holding bf16 values)."""
    rng = np.random.RandomState(seed)
    b, h = 2, 2
    shapes = [(b, tlen, h, dh)] * 3 + [(tlen, h, dh), (h, dh), (tlen, h)]
    args = [np.asarray(jnp.asarray(rng.randn(*s), jnp.bfloat16).astype(jnp.float32))
            for s in shapes]
    return args, rng.randn(b, tlen, h, dh).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(dh, tlen):
    """Inputs, gradient, and JAX's output and gradients in bf16 and in
    float32 (the same bf16-valued inputs)."""
    args, g = _inputs(dh, tlen, seed=3 * tlen + dh)
    runs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out, vjp = jax.vjp(lambda *a: jax_flash(*a, True),
                           *(jnp.asarray(x, dt) for x in args))
        runs[dt] = (np.asarray(out, np.float32),
                    [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))])
    return args, g, runs[jnp.bfloat16], runs[jnp.float32]


def _port(args, g):
    leaves = [t(x).to(torch.bfloat16).requires_grad_() for x in args]
    out = fa.flash_rel_attention(*leaves)
    out.backward(t(g))
    assert out.dtype == torch.float32
    assert all(x.grad.dtype == torch.bfloat16 for x in leaves)
    return out.detach(), [x.grad.float() for x in leaves]


def row_flip(args) -> np.ndarray:
    """Condition 1's allowance from the plain bf16 scores."""
    q, k, v, re, u, rb = (t(x).to(torch.bfloat16) for x in args)
    *_, scores = fa._bf16_parts(q, k, re, u, rb)
    return flip_allowance(scores, args[2])


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("tlen", T_VALUES)
def test_plain_bf16_forms_match_jax(dh, tlen):
    args, g, (out16, grads16), (out32, grads32) = _jax(dh, tlen)
    out, grads = _port(args, g)
    hold_bf16("out", out.numpy(), out16, FWD_RTOL * np.abs(out16).max() + row_flip(args),
              out32)
    for name, got, ref, ref32 in zip(NAMES, grads, grads16, grads32):
        hold_bf16(name, got.numpy(), ref,
                  np.maximum(GRAD_RTOL * np.abs(ref).max(), bf16_step(ref)), ref32)


def test_forward_keeps_the_float32_sums_and_lse():
    """The plain forward's lse is the scores' logsumexp and its sums the
    float32 P's product with v: both within 1e-6 of a float64 recompute;
    its output is the rounded P's product (not the sums)."""
    args, _ = _inputs(64, 150, seed=7)
    q, k, v, re, u, rb = (t(x).to(torch.bfloat16) for x in args)
    out, lse, sums = fa.flash_bf16_forward_plain(q, k, v, re, u, rb)
    *_, scores = fa._bf16_parts(q, k, re, u, rb)
    prob = torch.softmax(scores.double(), -1)
    want_sums = torch.einsum("bnij,bjnd->bind", prob, v.double())
    torch.testing.assert_close(sums.double(), want_sums, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse.double(), torch.logsumexp(scores.double(), -1),
                               rtol=0, atol=1e-6)
    assert (out - sums).abs().max() > 1e-4


def _backward_with_d_from_output(q, k, v, re, u, rb, grad):
    """The plain bf16 backward with D_i = dO_i . O_i, O the output of the
    rounded P (what the float32 kernel's D would read)."""
    with torch.no_grad():
        qf, kf, ref, rbf, qu, scale, bd_of, scores = fa._bf16_parts(q, k, re, u, rb)
        prob = torch.softmax(scores, dim=-1)
        go = fa._round(grad.float())
        out = fa.flash_bf16_forward_plain(q, k, v, re, u, rb)[0]
        dp = torch.einsum("bind,bjnd->bnij", go, v.float())
        d = (go * out).sum(-1).transpose(1, 2)[..., None]
        ds = fa._round(prob * (dp - d) / scale)
        dk = torch.einsum("bnij,bind->bjnd", ds, qu)
        dq_ac = torch.einsum("bnij,bjnd->bind", ds, kf)
    leaves = [x.detach().requires_grad_() for x in (qf, ref, rbf)]
    with torch.enable_grad():
        dq_bd, dre, drb = torch.autograd.grad(bd_of(*leaves), leaves, ds)
    return {"dq": dq_ac + dq_bd, "dk": dk, "d r_emb": dre, "d r_w_bias": dq_ac.sum((0, 1)),
            "d r_bias": drb}


@pytest.mark.parametrize("dh,tlen", [(16, 33), (32, 129), (64, 150)])
def test_d_from_the_rounded_output_misses_the_bar(dh, tlen):
    """With D from the rounded P's output every leaf sits at about half of
    JAX's bf16-to-float32 distance or farther (condition 3; measured 0.47 to
    1.17, against at most 0.08 with the float32 P), and some element misses
    condition 2."""
    args, g, (_, grads16), (_, grads32) = _jax(dh, tlen)
    wrong = _backward_with_d_from_output(*(t(x).to(torch.bfloat16) for x in args), t(g))
    over = 0
    for name, ref, ref32 in zip(NAMES, grads16, grads32):
        if name == "dv":          # D does not enter dv
            continue
        got = wrong[name].to(torch.bfloat16).float().numpy()
        slack = np.maximum(GRAD_RTOL * np.abs(ref).max(), bf16_step(ref))
        over += int((np.abs(got - ref) > slack).sum())
        ratio = np.linalg.norm(got - ref) / np.linalg.norm(ref - ref32)
        assert ratio > QUARTER, f"{name}: {ratio:.3f} of the distance"
    assert over > 0


def test_row_stride_takes_whole_16_byte_rows():
    """The kernels read rows in 16-byte pieces: a bf16 view of a fused
    projection passes, a bf16 row stride of 4 more elements (8 bytes) does
    not, while the same stride in float32 (16 bytes) does."""
    from transformer_transducer_tpu_torch.ops.cuda import common
    b, tlen, h, dh = 2, 5, 2, 32
    qkv = torch.zeros(b, tlen, 3, h, dh, dtype=torch.bfloat16)
    assert common.row_stride(qkv[:, :, 1], "k") == 3 * h * dh
    for dtype, ok in ((torch.bfloat16, False), (torch.float32, True)):
        rows = torch.zeros(b, tlen, h * dh + 4, dtype=dtype)[..., :h * dh]
        view = rows.view(b, tlen, h, dh)
        if ok:
            assert common.row_stride(view, "q") == h * dh + 4
        else:
            with pytest.raises(ValueError, match="16 bytes"):
                common.row_stride(view, "q")


def test_flash_wrapper_refuses_mixed_dtypes():
    args, _ = _inputs(32, 9, seed=1)
    q, k, v, re, u, rb = (t(x).to(torch.bfloat16) for x in args)
    with pytest.raises(TypeError, match="r_w_bias must be torch.bfloat16"):
        fa.flash_rel_attention(q, k, v, re, u.float(), rb)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_rel_attention(q.half(), k, v, re, u, rb)
