"""PyTorch port on the card: each CUDA kernel against its plain version (the
attention forward and backward, the RNN-T lattice sweeps), the launch
counters, the wrappers' input checks, a small encoder through the attention
kernels against the dense path, and gradients of whole models through the
kernels against the plain path.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card and
skips without one.  On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the parity tests,
and these tests import nothing of JAX.)

Tolerance: atol 1e-4, rtol 1e-4 for a kernel against its plain version
(fp32, another summation order and ``expf`` against ``torch.softmax``);
gradients through the attention backward, whose shared sums are fp32
atomics in a varying order, within atol 1e-4 * max|ref| + 1e-5 (the floor
for gradients that are 0 in exact arithmetic, as at T = 1) and rtol 1e-4; the
lattice sweeps within rtol 1e-5 / atol 1e-3 (log-alphas reach thousands).
"""

import pytest
import torch

from transformer_transducer_tpu_torch.models.attention import slice_pos_table
from transformer_transducer_tpu_torch.ops import rnnt_loss
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
    alpha_scan, alpha_scan_plain, beta_scan, beta_scan_plain)
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
    banded_attention, banded_attention_backward, banded_attention_plain)
from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
    flash_rel_attention, flash_rel_attention_backward, flash_rel_attention_plain)
from transformer_transducer_tpu_torch.ops.masks import context_mask, look_ahead_mask
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import (
    from_jax_params, random_jax_params)

pytestmark = pytest.mark.cuda

TOL = dict(atol=1e-4, rtol=1e-4)
B, H, DH, K_LEN = 2, 4, 64, 150


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, tlen, dh=DH):
    """q, k, v as strided views of one fused projection, as the model hands
    them over; tables of ``K_LEN`` rows sliced (or front-padded) to T."""
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    q, k, v = mk(B, tlen, 3, H, dh).unbind(2)
    return (q, k, v, slice_pos_table(mk(K_LEN, H, dh), tlen), mk(H, dh),
            slice_pos_table(mk(K_LEN, H), tlen))


# T around the kernels' 32-row query tile and 64-key chunk; 200 > K_LEN
@pytest.mark.parametrize("tlen", [1, 2, 31, 32, 33, 97, 200])
@pytest.mark.parametrize("left,right", [(10, 2), (0, 0), (64, 64), (3, 64), (64, 0)])
def test_banded_kernel_matches_plain(gen, tlen, left, right):
    args = _inputs(gen, tlen)
    before = banded_attention.launches
    got = banded_attention(*args, left, right)
    torch.cuda.synchronize()
    assert banded_attention.launches == before + 1
    torch.testing.assert_close(got, banded_attention_plain(*args, left, right), **TOL)


@pytest.mark.parametrize("tlen", [1, 2, 33, 64, 65, 200])
def test_flash_kernel_matches_plain(gen, tlen):
    args = _inputs(gen, tlen)
    before = flash_rel_attention.launches
    got = flash_rel_attention(*args)
    torch.cuda.synchronize()
    assert flash_rel_attention.launches == before + 1
    torch.testing.assert_close(got, flash_rel_attention_plain(*args), **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q, k, v, re, u, rb = _inputs(gen, 40)
    with pytest.raises(ValueError, match="Dh == 64"):
        flash_rel_attention(*_inputs(gen, 40, dh=32))
    with pytest.raises(ValueError, match="contiguous"):
        flash_rel_attention(q, k, v, re.transpose(1, 2).contiguous().transpose(1, 2),
                            u, rb)
    with pytest.raises(ValueError, match="is on cpu"):
        banded_attention(q, k, v, re, u.cpu(), rb, 10, 2)
    with pytest.raises(ValueError, match="outside"):
        banded_attention(q, k, v, re, u, rb, 10, 65)


def test_encoder_through_the_kernels_matches_the_dense_path(gen):
    """Two layers at head width 64: ``encode_banded`` (banded kernel) against
    ``encode`` under ``context_mask`` (dense), and a ``flash=True`` model's
    full-context encode (flash kernel) against the dense unmasked one."""
    layer = {"n_layer": 2, "n_head": 2, "d_model": 128, "d_head": DH,
             "d_inner": 256}
    cfg = Config({"enc": dict(layer, max_input_length=K_LEN),
                  "dec": dict(layer, max_target_length=42),
                  "joint": {"inner_size": 96}, "vocab_size": 40})
    state = from_jax_params(random_jax_params(cfg, seed=1))
    dense, fused = (build_transducer(cfg, flash=f, device="cuda") for f in (False, True))
    dense.load_state_dict(state)
    fused.load_state_dict(state)
    x = torch.randn(B, 70, 128, generator=gen, device="cuda")
    with torch.no_grad():
        banded = dense.encode_banded(x, 10, 2)
        masked = dense.encode(x, context_mask(70, 10, 2, device="cuda"))
        flash = fused.encode(x)
        full = dense.encode(x)
    torch.testing.assert_close(banded, masked, **TOL)
    torch.testing.assert_close(flash, full, **TOL)


def _grad_close(got, ref, name):
    tol = 1e-4 * ref.abs().max().item()
    torch.testing.assert_close(got, ref, atol=tol + 1e-5, rtol=1e-4, msg=name)


def _grads(fn, leaves, gout):
    for x in leaves:
        x.grad = None
    qkv, re, u, rb = leaves
    q, k, v = qkv.unbind(2)
    tlen = q.shape[1]
    out = fn(q, k, v, slice_pos_table(re, tlen), u, slice_pos_table(rb, tlen))
    out.backward(gout)
    return [out.detach()] + [x.grad.clone() for x in leaves]


@pytest.mark.parametrize("tlen", [1, 33, 97, 200])
@pytest.mark.parametrize("band", [None, (10, 2), (0, 0), (64, 64)])
def test_attention_backward_kernels_match_plain_autograd(gen, tlen, band):
    mk = lambda *s: (torch.randn(*s, generator=gen, device="cuda") * 0.5).requires_grad_()
    leaves = [mk(B, tlen, 3, H, DH), mk(K_LEN, H, DH), mk(H, DH), mk(K_LEN, H)]
    gout = torch.randn(B, tlen, H, DH, generator=gen, device="cuda")
    if band is None:
        kern, plain, counter = flash_rel_attention, flash_rel_attention_plain, \
            flash_rel_attention_backward
    else:
        kern = lambda *a: banded_attention(*a, *band)
        plain = lambda *a: banded_attention_plain(*a, *band)
        counter = banded_attention_backward
    before = counter.launches
    got = _grads(kern, leaves, gout)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = _grads(plain, leaves, gout)
    for name, a, b in zip(("out", "qkv", "r_emb", "r_w_bias", "r_bias"), got, ref):
        _grad_close(a, b, name)


def test_forward_kernels_keep_the_graph_and_raise_on_odd_inputs(gen):
    """No CUDA path returns a tensor cut off from the graph."""
    q, k, v, re, u, rb = _inputs(gen, 40)
    q.requires_grad_()
    assert flash_rel_attention(q, k, v, re, u, rb).grad_fn is not None
    assert banded_attention(q, k, v, re, u, rb, 10, 2).grad_fn is not None
    with torch.no_grad():
        assert flash_rel_attention(q, k, v, re, u, rb).grad_fn is None


@pytest.mark.parametrize("flash", [True, False])
def test_one_layer_model_gradients_through_the_kernels(gen, flash):
    """Every parameter of a one-layer model gets a gradient through the
    kernels (flash, or banded under the streaming band), equal to the plain
    path's."""
    layer = {"n_layer": 1, "n_head": 2, "d_model": 128, "d_head": DH,
             "d_inner": 256}
    cfg = Config({"enc": dict(layer, max_input_length=K_LEN, left_context=10,
                              right_context=2),
                  "dec": dict(layer, max_target_length=12),
                  "joint": {"inner_size": 96}, "vocab_size": 40})
    state = from_jax_params(random_jax_params(cfg, seed=2))
    kw = {"flash": True} if flash else {"banded": True}
    fused = build_transducer(cfg, device="cuda", **kw)
    plain = build_transducer(cfg, device="cuda")
    fused.load_state_dict(state)
    plain.load_state_dict(state)
    x = torch.randn(B, 70, 128, generator=gen, device="cuda")
    y = torch.randint(1, 40, (B, 6), generator=gen, device="cuda")
    t_len = torch.tensor([70, 51], device="cuda")
    u_len = torch.tensor([6, 4], device="cuda")
    grads = []
    for model in (fused, plain):
        if model is fused:
            enc, dec = model.encode_both(x, y)
        else:     # the dense path, under the band's mask for the banded model
            enc = model.encode(x, None if flash else context_mask(70, 10, 2,
                                                                  device="cuda"))
            dec = model.predict(torch.nn.functional.pad(y, (1, 0)),
                                look_ahead_mask(7, device="cuda"))
        loss = rnnt_loss.rnnt_loss_fused(enc, dec, rnnt_loss.joint_params(model),
                                         y, t_len, u_len, chunk_size=16)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert g is not None, f"{name}: gradient missing"
        _grad_close(g, grads[1][name], name)


@pytest.mark.parametrize("b,tlen,u", [(4, 410, 42), (2, 1, 0), (3, 37, 1), (2, 37, 42)])
def test_lattice_kernels_match_plain(gen, b, tlen, u):
    lp_b = -torch.rand(b, tlen, u + 1, generator=gen, device="cuda") * 5
    lp_l = -torch.rand(b, tlen, u + 1, generator=gen, device="cuda") * 5
    sb = rnnt_loss._skew(lp_b).contiguous()
    sl = rnnt_loss._skew(lp_l).contiguous()
    inject = torch.full_like(sb, rnnt_loss.NEG)
    inject[:, -1, -1] = sb[:, -1, -1]
    before = (alpha_scan.launches, beta_scan.launches)
    alpha, beta = alpha_scan(sb, sl), beta_scan(sb, sl, inject)
    torch.cuda.synchronize()
    assert (alpha_scan.launches, beta_scan.launches) == (before[0] + 1, before[1] + 1)
    tol = dict(rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(alpha, alpha_scan_plain(sb, sl), **tol)
    torch.testing.assert_close(beta, beta_scan_plain(sb, sl, inject), **tol)


def test_loss_on_the_card_matches_the_cpu(gen):
    """Loss and gradients of ``rnnt_loss_grid`` through the kernels against
    the same call on the CPU (eager scans), with t_len == 0, u_len == 0 and
    over-length rows."""
    b, tlen, u = 5, 30, 8
    lp_b = -torch.rand(b, tlen, u + 1, generator=gen, device="cuda") * 3
    lp_l = -torch.rand(b, tlen, u + 1, generator=gen, device="cuda") * 3
    t_len = torch.tensor([30, 0, 12, 40, 7])
    u_len = torch.tensor([8, 3, 0, 11, 8])
    out = []
    for dev in ("cuda", "cpu"):
        a = lp_b.detach().to(dev).requires_grad_()
        c = lp_l.detach().to(dev).requires_grad_()
        loss = rnnt_loss.rnnt_loss_grid(a, c, t_len, u_len)
        loss.sum().backward()
        out.append([loss.detach().cpu(), a.grad.cpu(), c.grad.cpu()])
    for got, ref in zip(*out):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_lattice_wrappers_reject_what_the_kernels_do_not_take(gen):
    sb = torch.zeros(1, 1100, 1025, device="cuda")
    with pytest.raises(ValueError, match="U1 <="):
        alpha_scan(sb, sb)
    with pytest.raises(TypeError, match="float32"):
        alpha_scan(sb[:, :4, :4].double(), sb[:, :4, :4].double())
