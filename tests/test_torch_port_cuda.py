"""PyTorch port on the card: each CUDA kernel against its plain version (the
attention forward and backward at head widths 32 and 64, the banded
forward's row log-sum-exp too, strided inputs and two launches to the
bit), the RNN-T lattice
sweeps (U1 1 to 1024, ragged rows, misaligned views, bit-identical and
under a CUDA graph), the pruned loss's logZ at any U1, V and alignment, on spiked
logits that its exact pass takes, bit-identical and under a CUDA graph,
and band sweeps up to S = 128),
the launch counters, the wrappers' input checks, a
small encoder through the attention kernels against the dense path,
gradients of whole models through the kernels against the plain path,
the pruned loss on the card against the CPU, the banded forward at the
streaming window (T = 256, B = 1 and 16), and the streaming sessions on the
card against the same sessions through the plain version.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card and
skips without one.  On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the parity tests,
and these tests import nothing of JAX.)

Tolerance: atol 1e-4, rtol 1e-4 for a kernel against its plain version
(fp32, another summation order and ``expf`` against ``torch.softmax``);
gradients through the attention backward (the flash backward's shared
sums are fp32 atomics in a varying order) within atol 1e-4 * max|ref| + 1e-5 (the floor
for gradients that are 0 in exact arithmetic, as at T = 1) and rtol 1e-4; the
lattice and band sweeps within rtol 1e-5 / atol 1e-3 (log-alphas reach
thousands; the band sweeps against their plain versions run in float64,
both sides clamped at NEG, with the same cells at or below NEG / 2).
"""

import pytest
import torch

from transformer_transducer_tpu_torch.models.attention import (
    rel_attention_scores, slice_pos_table)
from transformer_transducer_tpu_torch.ops import rnnt_loss, rnnt_loss_pruned
from transformer_transducer_tpu_torch.ops.cuda import band_kernel, rnnt_kernel
from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
    band_alpha, band_alpha_plain, band_alpha_plan, band_beta, band_beta_plain)
from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import (
    additive_logz, additive_logz_plain, marked_cells)
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
    NEG, alpha_scan, alpha_scan_plain, beta_scan, beta_scan_plain)
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops.cuda.common import launch_forward
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


@pytest.mark.parametrize("tlen", [1, 33, 97, 200])
@pytest.mark.parametrize("left,right", [(10, 2), (64, 64)])
def test_banded_kernel_matches_plain_at_head_width_32(gen, tlen, left, right):
    args = _inputs(gen, tlen, dh=32)
    before = banded_attention.launches
    got = banded_attention(*args, left, right)
    torch.cuda.synchronize()
    assert banded_attention.launches == before + 1
    torch.testing.assert_close(got, banded_attention_plain(*args, left, right), **TOL)


def _banded_forward(args, band):
    """The banded forward kernel's output and row log-sum-exp."""
    with torch.no_grad():
        out, lse, launched = launch_forward("ttx_banded_attention_fwd", args, band,
                                            with_lse=True)
    torch.cuda.synchronize()
    assert launched
    return out, lse


# the banded forward's 32-row blocks and 16-offset chunks (T 47-49: the 47
# keys a chunk stages); 410, 513 > K_LEN: the tables front-padded
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tlen", [1, 31, 32, 33, 47, 48, 49, 410, 513])
@pytest.mark.parametrize("band", [(10, 2), (3, 64), (64, 0), (64, 64)])
def test_banded_forward_lse_matches_masked_logsumexp(gen, tlen, band, dh):
    """The output against the plain version and the row log-sum-exp (which
    the backward reads) against the band-masked logsumexp of the plain
    version's scores."""
    args = _inputs(gen, tlen, dh)
    out, lse = _banded_forward(args, band)
    scores = rel_attention_scores(args[0], args[1], *args[3:])
    scores = scores.masked_fill(context_mask(tlen, *band, device="cuda"), -torch.inf)
    torch.testing.assert_close(out, banded_attention_plain(*args, *band), **TOL)
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1), **TOL)


@pytest.mark.parametrize("tlen", [33, 410])
@pytest.mark.parametrize("band", [(10, 2), (64, 64)])
def test_banded_forward_takes_strided_and_contiguous_inputs_alike(gen, tlen, band):
    """Row-strided q, k, v views of a packed qkv and contiguous copies give
    the same output and log-sum-exp, to the bit."""
    q, k, v, *tables = _inputs(gen, tlen)
    assert q.stride(1) == 3 * H * DH
    strided = _banded_forward((q, k, v, *tables), band)
    packed = _banded_forward((q.contiguous(), k.contiguous(), v.contiguous(), *tables),
                             band)
    for name, a, b in zip(("out", "lse"), strided, packed):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("tlen,band", [(410, (10, 2)), (200, (64, 64)), (1, (0, 0))])
def test_banded_forward_is_deterministic(gen, tlen, band):
    """Two launches on the same inputs give bit-identical outputs and
    log-sum-exps: every entry is written once, with no atomics."""
    args = _inputs(gen, tlen)
    first, second = _banded_forward(args, band), _banded_forward(args, band)
    for name, a, b in zip(("out", "lse"), first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b), name


# T around the forward's 128-row query tile and 32-key chunk
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tlen", [1, 2, 31, 32, 33, 64, 65, 127, 128, 129, 200])
def test_flash_kernel_matches_plain(gen, tlen, dh):
    args = _inputs(gen, tlen, dh)
    before = flash_rel_attention.launches
    got = flash_rel_attention(*args)
    torch.cuda.synchronize()
    assert flash_rel_attention.launches == before + 1
    torch.testing.assert_close(got, flash_rel_attention_plain(*args), **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q, k, v, re, u, rb = _inputs(gen, 40)
    with pytest.raises(ValueError, match=r"take Dh in \(32, 64\), got 48"):
        flash_rel_attention(*_inputs(gen, 40, dh=48))
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


def _check_backward(gen, tlen, band, dh):
    mk = lambda *s: (torch.randn(*s, generator=gen, device="cuda") * 0.5).requires_grad_()
    leaves = [mk(B, tlen, 3, H, dh), mk(K_LEN, H, dh), mk(H, dh), mk(K_LEN, H)]
    gout = torch.randn(B, tlen, H, dh, generator=gen, device="cuda")
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


# 16, 32, 64, 65: the flash backward's 32-row query tiles and 64-key chunks
@pytest.mark.parametrize("tlen", [1, 16, 32, 33, 64, 65, 97, 200, 410])
@pytest.mark.parametrize("band", [None, (10, 2), (0, 0), (64, 64)])
def test_attention_backward_kernels_match_plain_autograd(gen, tlen, band):
    _check_backward(gen, tlen, band, DH)


@pytest.mark.parametrize("tlen", [1, 33, 129, 200])
@pytest.mark.parametrize("band", [None, (10, 2), (64, 64)])
def test_attention_backward_kernels_at_head_width_32(gen, tlen, band):
    _check_backward(gen, tlen, band, 32)


# the banded backward's tiles: 32 rows and keys a block, cell tiles of 48
# rows and 16 offsets
@pytest.mark.parametrize("tlen", [31, 32, 33, 47, 48, 49, 63, 64, 65, 95, 96, 97])
@pytest.mark.parametrize("band", [(10, 2), (3, 64), (64, 0)])
def test_banded_backward_at_its_tile_edges(gen, tlen, band):
    _check_backward(gen, tlen, band, DH)


def _strided_and_contiguous_grads(gen, tlen, fn):
    """The six gradients of ``fn`` for row-strided q, k, v views of a packed
    qkv (as the model hands them over) and for contiguous copies."""
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    qkv = mk(B, tlen, 3, H, DH)
    tables = (slice_pos_table(mk(K_LEN, H, DH), tlen), mk(H, DH),
              slice_pos_table(mk(K_LEN, H), tlen))
    gout = torch.randn(B, tlen, H, DH, generator=gen, device="cuda")
    strided = qkv.unbind(2)
    assert strided[0].stride(1) == 3 * H * DH
    grads = []
    for q, k, v in (strided, [x.contiguous() for x in strided]):
        leaves = [x.detach().requires_grad_() for x in (q, k, v, *tables)]
        fn(*leaves).backward(gout)
        grads.append([x.grad for x in leaves])
    return grads


@pytest.mark.parametrize("tlen", [33, 410])
def test_flash_backward_takes_strided_and_contiguous_inputs_alike(gen, tlen):
    """Row-strided q, k, v views of a packed qkv (as the model hands them
    over) and contiguous copies give the same gradients."""
    grads = _strided_and_contiguous_grads(gen, tlen, flash_rel_attention)
    for name, a, b in zip(("q", "k", "v", "r_emb", "r_w_bias", "r_bias"), *grads):
        _grad_close(a, b, name)


@pytest.mark.parametrize("tlen", [33, 410])
@pytest.mark.parametrize("band", [(10, 2), (64, 64)])
def test_banded_backward_takes_strided_and_contiguous_inputs_alike(gen, tlen, band):
    """The banded backward on strided views and on contiguous copies: the
    same gradients, to the bit (it sums in a fixed order)."""
    grads = _strided_and_contiguous_grads(
        gen, tlen, lambda *a: banded_attention(*a, *band))
    for name, a, b in zip(("q", "k", "v", "r_emb", "r_w_bias", "r_bias"), *grads):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("tlen,band", [(410, (10, 2)), (200, (64, 64)), (1, (0, 0))])
def test_banded_backward_is_deterministic(gen, tlen, band):
    """Two launches on the same inputs give bit-identical gradients: no
    atomics, and the table partials are summed in a fixed order."""
    args = _inputs(gen, tlen)
    with torch.no_grad():
        out, lse, _ = launch_forward("ttx_banded_attention_fwd", args, band, with_lse=True)
    gout = torch.randn(B, tlen, H, DH, generator=gen, device="cuda")
    first = banded_attention_backward(*args, out, lse, gout, *band)
    second = banded_attention_backward(*args, out, lse, gout, *band)
    torch.cuda.synchronize()
    for name, a, b in zip(("q", "k", "v", "r_emb", "r_w_bias", "r_bias"), first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b), name


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


def _lattice_inputs(gen, b, tlen, u, offset=0):
    """``chip_smoke.lattice_inputs``'s grids (row 0 full length, row 1 with
    no frames, the rest ragged), as views ``offset`` floats into their
    storage: at an odd offset every row of the kernels' staged spans starts
    off its 16-byte alignment."""
    from chip_smoke import lattice_inputs
    grids = lattice_inputs(b, tlen, u, gen)
    if not offset:
        return grids
    out = []
    for g in grids:
        flat = torch.empty(g.numel() + offset, device="cuda")
        flat[offset:] = g.reshape(-1)
        out.append(flat[offset:].view(g.shape))
    return out


# U1 around one warp's 32 lanes of K = 1, 2 and 4 cells, past it (several
# warps) and at the most the kernels take
@pytest.mark.parametrize("b,tlen,u", [(4, 410, 42), (2, 1, 0), (3, 37, 1), (2, 37, 42),
                                      (3, 37, 30), (3, 37, 31), (3, 37, 32), (3, 37, 63),
                                      (3, 37, 64), (3, 37, 127), (3, 37, 128), (2, 37, 1023)])
def test_lattice_kernels_match_plain(gen, b, tlen, u):
    """Full-length rows with the inject on the last cell, then the loss's
    ragged rows (a zero-length one among them) at every float offset."""
    lp_b = -torch.rand(b, tlen, u + 1, generator=gen, device="cuda") * 5
    lp_l = -torch.rand(b, tlen, u + 1, generator=gen, device="cuda") * 5
    sb = rnnt_loss._skew(lp_b).contiguous()
    sl = rnnt_loss._skew(lp_l).contiguous()
    inject = torch.full_like(sb, rnnt_loss.NEG)
    inject[:, -1, -1] = sb[:, -1, -1]
    cases = [(sb, sl, inject)] + [_lattice_inputs(gen, b, tlen, u, offset)
                                  for offset in range(4)]
    tol = dict(rtol=1e-5, atol=1e-3)
    for sb, sl, inject in cases:
        before = (alpha_scan.launches, beta_scan.launches)
        alpha, beta = alpha_scan(sb, sl), beta_scan(sb, sl, inject)
        torch.cuda.synchronize()
        assert (alpha_scan.launches, beta_scan.launches) == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(alpha, alpha_scan_plain(sb, sl), **tol)
        torch.testing.assert_close(beta, beta_scan_plain(sb, sl, inject), **tol)


def test_lattice_log1p_is_log1pf_to_the_bit(gen):
    """The sweeps' branch-free log1p equals log1pf on every float in
    [0, 1], the values exp(-|a - b|) takes."""
    assert rnnt_kernel.log1p_mismatches() == 0


@pytest.mark.parametrize("u", [42, 128, 1023])
@pytest.mark.parametrize("sweep", ["alpha", "beta"])
def test_lattice_sweeps_are_deterministic_and_graph_safe(gen, sweep, u):
    """Two launches of a lattice sweep agree to the bit, and a CUDA graph's
    replay gives the eager call's result."""
    sb, sl, inject = _lattice_inputs(gen, 4, 410 if u < 1023 else 37, u, offset=1)
    run = {"alpha": lambda: alpha_scan(sb, sl),
           "beta": lambda: beta_scan(sb, sl, inject)}[sweep]
    first, again = run(), run()
    assert torch.equal(first, again)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


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


# ---------------------------------------------------------------------------
# The pruned loss: logZ (csrc/additive_logz.cu) and band sweeps
# (csrc/rnnt_pruned.cu)
# ---------------------------------------------------------------------------

# U1 past 64 takes a second (and third) block of label rows
@pytest.mark.parametrize("b,tlen,u1,v", [(4, 410, 43, 6485), (1, 1, 1, 37), (2, 17, 6, 129),
                                         (3, 9, 64, 300), (1, 33, 43, 128), (2, 37, 65, 300),
                                         (2, 37, 129, 6485)])
def test_logz_kernel_matches_plain(gen, b, tlen, u1, v):
    a = torch.randn(b, tlen, v, generator=gen, device="cuda") * 3
    l = torch.randn(b, u1, v, generator=gen, device="cuda") * 3
    before = additive_logz.launches
    got = additive_logz(a, l)
    torch.cuda.synchronize()
    assert additive_logz.launches == before + 1 and got.shape == (b, tlen, u1)
    torch.testing.assert_close(got, additive_logz_plain(a, l), **TOL)


def _spiked(gen, b, tlen, u1, v, margin):
    """randn * 3 logits with a peak ``margin`` nats above the row maximum on
    symbol 3 in about half the rows of A and on symbol 7 in about half the
    rows of L; returns (A, L, the cells whose rows both peak)."""
    a = torch.randn(b, tlen, v, generator=gen, device="cuda") * 3
    l = torch.randn(b, u1, v, generator=gen, device="cuda") * 3
    sa = torch.rand(b, tlen, generator=gen, device="cuda") < 0.5
    sl = torch.rand(b, u1, generator=gen, device="cuda") < 0.5
    sa[0, 0] = sl[0, 0] = True
    a[..., 3] = torch.where(sa, a.amax(-1) + margin, a[..., 3])
    l[..., 7] = torch.where(sl, l.amax(-1) + margin, l[..., 7])
    return a, l, sa[:, :, None] & sl[:, None, :]


# a peak on different symbols in A[t] and L[u]: up to 30 nats every cell is
# certified; from 100 on exactly the cells whose rows both peak go to the
# exact pass
@pytest.mark.parametrize("margin", [0, 30, 100, 1000])
@pytest.mark.parametrize("b,tlen,u1,v", [(2, 19, 6, 130), (4, 410, 43, 6485), (2, 70, 65, 37)])
def test_logz_kernel_on_spiked_logits(gen, b, tlen, u1, v, margin):
    a, l, both = _spiked(gen, b, tlen, u1, v, margin)
    got = additive_logz(a, l)
    marked = marked_cells()
    torch.testing.assert_close(got, additive_logz_plain(a, l), **TOL)
    if margin <= 30:
        assert marked == 0
    else:
        assert marked == int(both.sum()) > 0


@pytest.mark.parametrize("b,tlen,u1,v", [(4, 410, 43, 6485), (2, 37, 129, 300)])
def test_logz_kernel_is_deterministic(gen, b, tlen, u1, v):
    a, l, _ = _spiked(gen, b, tlen, u1, v, 100)
    first, again = additive_logz(a, l), additive_logz(a, l)
    assert marked_cells() > 0
    assert torch.equal(first, again)


def test_logz_kernel_replays_in_a_cuda_graph(gen):
    """All four launches captured in one graph; its replay gives the eager
    call's bits, exact pass included."""
    a, l, _ = _spiked(gen, 4, 410, 43, 6485, 100)
    eager = additive_logz(a, l)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        additive_logz(a, l)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = additive_logz(a, l)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


# V not a multiple of 4 (4-byte copies, a scalar head and tail in the row
# maxima), and rows that start off a 16-byte boundary
@pytest.mark.parametrize("b,tlen,u1,v", [(2, 19, 6, 5), (4, 410, 43, 6487), (3, 65, 9, 131)])
def test_logz_kernel_takes_any_vocabulary_and_alignment(gen, b, tlen, u1, v):
    a = torch.randn(b, tlen, v, generator=gen, device="cuda") * 3
    l = torch.randn(b, u1, v, generator=gen, device="cuda") * 3
    torch.testing.assert_close(additive_logz(a, l), additive_logz_plain(a, l), **TOL)
    # the same values one float into a buffer: contiguous, not 16-byte aligned
    ab = torch.empty(a.numel() + 1, device="cuda")
    lb = torch.empty(l.numel() + 1, device="cuda")
    a1, l1 = ab[1:].view_as(a).copy_(a), lb[1:].view_as(l).copy_(l)
    assert a1.is_contiguous() and a1.data_ptr() % 16 != 0
    torch.testing.assert_close(additive_logz(a1, l1), additive_logz_plain(a, l), **TOL)


def _band_inputs(gen, b, tlen, s_range, bad_shifts=False):
    """Band grids with label cells past a random u_len at NEG, monotone band
    starts (steps in [0, S)), ragged t_len with a zero-length row, and the
    terminal slot clamped at the band's edge for one row."""
    lp_b = torch.log(torch.rand(b, tlen, s_range, generator=gen, device="cuda") * 0.95 + 0.05)
    lp_l = torch.log(torch.rand(b, tlen, s_range, generator=gen, device="cuda") * 0.95 + 0.05)
    steps = torch.randint(0, s_range, (b, tlen), generator=gen, device="cuda")
    steps[:, 0] = 0
    rs = torch.cumsum(steps, dim=1)
    u_len = rs[:, -1] + torch.randint(0, s_range, (b,), generator=gen, device="cuda")
    uidx = rs[:, :, None] + torch.arange(s_range, device="cuda")
    lp_l = torch.where(uidx < u_len[:, None, None], lp_l, torch.full_like(lp_l, NEG))
    t_len = torch.randint(1, tlen + 1, (b,), generator=gen, device="cuda")
    t_len[0] = tlen
    if b > 1:
        t_len[1] = 0
    if b > 2:
        u_len[2] = u_len[2] + 3 * s_range          # sf clamps at S - 1
    d = rs[:, 1:] - rs[:, :-1]
    if bad_shifts and tlen > 3:
        d[0, 1], d[-1, 2] = -1, s_range
    _, tf, sf = rnnt_loss_pruned._band_terminal(lp_b, rs, t_len, u_len)
    return lp_b, lp_l, rs, t_len, u_len, d, tf, sf


def _assert_band_close(got, want, what):
    """The band sweeps' rule: within rtol 1e-5 / atol 1e-3 with both sides
    clamped at NEG, and the same cells at or below NEG / 2."""
    torch.testing.assert_close(got.clamp(min=NEG), want.clamp(min=NEG), rtol=1e-5,
                               atol=1e-3, msg=what)
    assert torch.equal(got <= NEG / 2, want <= NEG / 2), f"{what}: unreachable cells differ"


# S past 32: each lane holds ceil(S / 32) band slots
@pytest.mark.parametrize("s_range", [1, 2, 3, 5, 8, 32, 33, 64, 128])
@pytest.mark.parametrize("b,tlen", [(4, 410), (3, 1), (5, 37)])
def test_band_kernels_match_plain(gen, b, tlen, s_range):
    lp_b, lp_l, rs, t_len, u_len, d, tf, sf = _band_inputs(gen, b, tlen, s_range,
                                                           bad_shifts=True)
    pad = torch.nn.functional.pad
    d_alpha, d_beta = pad(d, (1, 0)), pad(d, (0, 1))
    before = (band_alpha.launches, band_beta.launches)
    alpha = band_alpha(lp_b, lp_l, d_alpha, s_range)
    beta = band_beta(lp_b, lp_l, d_beta, tf, sf, s_range)
    torch.cuda.synchronize()
    assert (band_alpha.launches, band_beta.launches) == (before[0] + 1, before[1] + 1)
    # the plain sweeps in float64: in float32 their own rounding reaches 1.7x
    # (alpha) and 0.9x (beta) the tolerance at S = 128, T = 410 (log-alphas
    # near -17600, log-betas near -20800), where the kernels, with their
    # float64 offsets, are nearer the exact values
    ref = band_alpha_plain(lp_b.double(), lp_l.double(), d_alpha).float()
    ref_b = band_beta_plain(lp_b.double(), lp_l.double(), d_beta, tf, sf).float()
    plan = band_alpha_plan(tlen, s_range)
    _assert_band_close(alpha, ref, f"alpha, the plan's {plan} chunks")
    _assert_band_close(beta, ref_b, f"beta, the plan's {plan} chunks")
    # the chunk counts forced through the launches' private argument
    for n in (1, 2, 7):
        _assert_band_close(band_kernel._launch_alpha(lp_b, lp_l, d_alpha, n), ref,
                           f"alpha, {n} chunks")
        _assert_band_close(band_kernel._launch_beta(lp_b, lp_l, d_beta, tf, sf, n), ref_b,
                           f"beta, {n} chunks")


@pytest.mark.parametrize("s_range,n_chunks", [(5, None), (5, 7), (2, None), (33, 3)])
@pytest.mark.parametrize("sweep", ["alpha", "beta"])
def test_band_alpha_is_deterministic_and_graph_safe(gen, sweep, s_range, n_chunks):
    """Two launches of a chunked band sweep (the alpha, or the beta) agree
    to the bit, and a CUDA graph's replay gives the eager call's result (no
    host read, workspace from the graph's pool)."""
    lp_b, lp_l, _, _, _, d, tf, sf = _band_inputs(gen, 4, 410, s_range, bad_shifts=True)
    pad = torch.nn.functional.pad
    run = {"alpha": lambda: band_kernel._launch_alpha(lp_b, lp_l, pad(d, (1, 0)), n_chunks),
           "beta": lambda: band_kernel._launch_beta(lp_b, lp_l, pad(d, (0, 1)), tf, sf,
                                                     n_chunks)}[sweep]
    first, again = run(), run()
    assert torch.equal(first, again)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@pytest.mark.parametrize("simple_scale", [0.0, 0.25])
def test_pruned_loss_on_the_card_matches_the_cpu(gen, simple_scale, monkeypatch):
    """Loss and gradients of ``rnnt_loss_pruned`` through the three kernels
    and the lattice sweeps against the same call on the CPU (plain
    versions), with a zero-length row; the band starts are equal.  The CPU's
    band sweeps are their plain sweeps run in float64: the occupancies
    exp(alpha + beta - logZ) carry both sweeps' rounding into every gradient,
    the float32 sweeps' own rounding moves them by up to 0.3 (alpha) and
    1.1 (beta, at simple scale 0.25; ``tools/grad_rounding.py``) of the
    tolerance, and the kernels (their chunks, their offsets) lie nearer the
    exact values."""
    b, tlen, u, d, inner, v = 3, 50, 9, 16, 24, 40
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    tensors = [mk(b, tlen, d), mk(b, u + 1, d), mk(d, inner), mk(d, inner), mk(inner),
               mk(inner, v), mk(v)]
    labels = torch.randint(1, v, (b, u), generator=gen, device="cuda")
    t_len, u_len = torch.tensor([50, 0, 31]), torch.tensor([9, 4, 6])
    out = []
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            monkeypatch.setattr(rnnt_loss_pruned, "band_alpha", lambda lp_b, lp_l, d, s: (
                band_alpha_plain(lp_b.double(), lp_l.double(), d).float()))
            monkeypatch.setattr(rnnt_loss_pruned, "band_beta", lambda lp_b, lp_l, d, tf, sf, s: (
                band_beta_plain(lp_b.double(), lp_l.double(), d, tf, sf).float()))
        leaves = [x.detach().to(dev).requires_grad_() for x in tensors]
        losses = rnnt_loss_pruned.rnnt_loss_pruned(
            leaves[0], leaves[1], leaves[2:], labels.to(dev), t_len, u_len, s_range=3,
            chunk_size=16, reduction="none", simple_scale=simple_scale)
        grads = torch.autograd.grad(losses.sum(), leaves)
        out.append([losses.detach().cpu()] + [g.cpu() for g in grads])
    assert out[0][0][1].item() == 0.0
    for got, ref in zip(*out):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_banded_loss_gradients_on_the_card(gen):
    """The band DP's analytic backward (beta kernel) against autograd
    through the oracle, on the card."""
    lp_b, lp_l, rs, t_len, u_len, *_ = _band_inputs(gen, 4, 120, 5)
    a, c = lp_b.clone().requires_grad_(), lp_l.clone().requires_grad_()
    rnnt_loss_pruned.rnnt_loss_banded(a, c, rs, t_len, u_len).sum().backward()
    a2, c2 = lp_b.clone().requires_grad_(), lp_l.clone().requires_grad_()
    rnnt_loss_pruned.rnnt_loss_banded_grid(a2, c2, rs, t_len, u_len).sum().backward()
    torch.testing.assert_close(a.grad, a2.grad, rtol=1e-3, atol=5e-4)
    torch.testing.assert_close(c.grad, c2.grad, rtol=1e-3, atol=5e-4)
    assert not a.grad[1].any()


def test_pruned_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.zeros(1, 4, 129, device="cuda")
    d = torch.zeros(1, 4, dtype=torch.long, device="cuda")
    with pytest.raises(ValueError, match="S <= 128, got 129"):
        band_alpha(x, x, d, 129)
    with pytest.raises(ValueError, match="inputs on different devices"):
        band_alpha(x[..., :4], x[..., :4], d.cpu(), 4)
    with pytest.raises(ValueError, match="empty vocabulary"):
        additive_logz(torch.zeros(1, 2, 0, device="cuda"), torch.zeros(1, 65, 0, device="cuda"))


# the streaming window: T pinned at 256 (18 x 10 + 36 + 18 x 2, rounded up
# to 64), one window or a group of 16, tables of the flagship's 410 rows
@pytest.mark.parametrize("b", [1, 16])
def test_banded_kernel_at_the_streaming_window(gen, b):
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    q, k, v = mk(b, 256, 3, 8, DH).unbind(2)
    args = (q, k, v, slice_pos_table(mk(410, 8, DH), 256), mk(8, DH),
            slice_pos_table(mk(410, 8), 256))
    before = banded_attention.launches
    got = banded_attention(*args, 10, 2)
    assert banded_attention.launches == before + 1
    torch.testing.assert_close(got, banded_attention_plain(*args, 10, 2), **TOL)


def _streaming_model(gen):
    """Two layers of 2 heads x 64 on the card (32 mels x 4 stacked frames =
    d_model 128), the blank logit biased so that some frames emit."""
    layer = {"n_layer": 2, "n_head": 2, "d_model": 128, "d_head": DH, "d_inner": 256}
    cfg = Config({"enc": dict(layer, max_input_length=410, left_context=10,
                              right_context=2),
                  "dec": dict(layer, max_target_length=42),
                  "joint": {"inner_size": 96}, "vocab_size": 40})
    model = build_transducer(cfg, device="cuda")
    model.load_state_dict(from_jax_params(random_jax_params(cfg, seed=3)))
    x = torch.randn(1, 200, 128, generator=gen, device="cuda")
    with torch.no_grad():
        logits = model.joint_logits(model.encode_banded(x, 10, 2),
                                    model.predict(torch.zeros((1, 1), dtype=torch.long,
                                                              device="cuda")))[0, :, 0]
        margin = logits[:, 1:].max(-1).values - logits[:, 0]
        model.joint.project_layer.bias[0] += torch.quantile(margin, 0.8)
    return model


def test_streaming_sessions_on_the_card_match_the_plain_versions(gen, monkeypatch):
    """Window, trapezoid and incremental sessions on the card: the window
    modes launch the banded kernel once a layer for each window group, and
    give the tokens of the same sessions through the plain version; the
    incremental session gives the window session's."""
    import numpy as np
    from transformer_transducer_tpu_torch.ops.cuda import banded_attention as ba
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession, TrapezoidStreamingSession)
    model = _streaming_model(gen)
    rng = np.random.RandomState(0)
    n = 48000
    wav = ((np.sin(np.arange(n) * 0.03) * 9000 + rng.randn(n) * 1500)
           * (np.sin(2 * np.pi * np.arange(n) / 12000) > -0.2)).astype(np.int16)

    def run(kind):
        cfg = StreamingConfig(n_layer=2, feature_dim=32, blank_split=4)
        session = (TrapezoidStreamingSession(model, cfg, device="cuda") if kind == "trapezoid"
                   else StreamingSession(model, cfg, device="cuda",
                                         incremental=kind == "incremental"))
        before = banded_attention.launches      # the wrapper's own counter
        for i in range(0, n, 1600):
            session.accept_waveform(wav[i:i + 1600])
        session.finalize()
        torch.cuda.synchronize()
        return session, banded_attention.launches - before

    kern = {kind: run(kind) for kind in ("window", "trapezoid", "incremental")}
    for kind, (session, launches) in kern.items():
        assert session.host_reads <= len(session.result) + session.windows
        want = 0 if kind == "incremental" else 2 * session.window_groups
        assert launches == want, (kind, launches, want)
    assert kern["window"][0].result, "degenerate test: nothing emitted"
    assert kern["incremental"][0].result == kern["window"][0].result
    monkeypatch.setattr(ba, "banded_attention", ba.banded_attention_plain)
    for kind in ("window", "trapezoid"):
        session, launches = run(kind)
        assert launches == 0
        assert session.result == kern[kind][0].result
        assert session.timestamps == kern[kind][0].timestamps
