"""PyTorch port: the schedule of the additive logZ kernel
(``csrc/additive_logz.cu``), proved on the CPU.

The CUDA kernel cannot run here, so this file emulates its four launches in
plain PyTorch: the row maxima in log2 units (``A * log2(e)`` rounded once),
p = 2^(a - mA) and q = 2^(l - mL), the product over V in slices of whole
32-column chunks, each chunk's first 16 columns in one warp's accumulator
and the last 16 in another's, added at the end; the 3xTF32 split on the
bits (``split`` in ``csrc/tensor_core.cuh``: hi by integer rounding, lo =
``cvt.rna.tf32`` of the rest) and each mma's 8-deep step entering the fp32
accumulator once; the slices summed in order; the underflow certificate
S >= V 2^-100 and the exact two-pass max / exp2-sum for the cells it leaves
out.  With ``ftz`` the emulation also flushes to zero every p, q and split
half below 2^-126, the losses the certificate bounds.

The result is held against the port's plain version, the JAX package's XLA
oracle and its Pallas kernel in interpret mode, on the same numpy inputs
(fp32, ``TOL``: rtol 2e-4, atol 2e-5).  Spiked inputs (a peak ``margin`` nats
above the rest, on one symbol in some rows of A and another in some rows of
L) put cells on both sides of the certificate; which cells go to the exact
pass is asserted.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.ops.pallas.logz_kernel import _logz_pallas, additive_logz_xla
from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import additive_logz_plain

from torch_port_helpers import TOL, t, tf32_rna

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
KC = 32                  # columns a chunk; a warp takes 16 of them
CERT_EXP = -100          # the certificate: S >= V 2^CERT_EXP
TINY = 2.0 ** -126       # fp32's smallest normal


def split_hi(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``split`` hi half: (bits + 0x1000) & 0xffffe000 on the
    unsigned bits (p, q >= 0 here)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = ((bits + 0x1000) & 0xFFFFE000).to(torch.int32)
    return hi.view(torch.float32)


def flush(x: torch.Tensor, ftz: bool) -> torch.Tensor:
    return torch.where(x.abs() < TINY, torch.zeros_like(x), x) if ftz else x


def product(p: torch.Tensor, q: torch.Tensor, ftz: bool) -> torch.Tensor:
    """p (B, T, K) . q (B, U1, K)^T as one warp's mma.sync steps: 3xTF32
    (lo.hi', hi.lo', hi.hi', in that order), each 8-deep step's exact sum
    entering the fp32 accumulator once; K a multiple of 8."""
    p_hi, q_hi = flush(split_hi(p), ftz), flush(split_hi(q), ftz)
    p_lo, q_lo = flush(tf32_rna(p - p_hi), ftz), flush(tf32_rna(q - q_hi), ftz)
    acc = torch.zeros(p.shape[0], p.shape[1], q.shape[1], dtype=torch.float32)
    for k in range(0, p.shape[-1], 8):
        for x, y in ((p_lo, q_hi), (p_hi, q_lo), (p_hi, q_hi)):
            acc = acc + (x[..., k:k + 8].double()
                         @ y[..., k:k + 8].double().transpose(-1, -2)).float()
    return acc


def slice_width(v: int, n_split: int) -> int:
    """Columns a slice when V is cut into ``n_split`` slices of whole chunks."""
    chunks = -(-v // KC)
    return -(-chunks // n_split) * KC


def exact_pass(a2: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """The two-pass max / exp2-sum over V of every cell, (B, T, U1)."""
    x = a2[:, :, None, :] + l2[:, None, :, :]
    m = x.amax(-1)
    return (m + torch.log2(torch.exp2(x - m[..., None]).sum(-1))) * LN2


def emulate(a: torch.Tensor, l: torch.Tensor, n_split: int, ftz: bool = False):
    """The kernel's logZ (B, T, U1), the cells left to the exact pass, the
    product's S and the log2-unit operands (a2, l2)."""
    v = a.shape[-1]
    a2, l2 = a * LOG2E, l * LOG2E                   # rounded once, fp32
    m_a, m_l = a2.amax(-1), l2.amax(-1)             # launch 1
    v_pad = -(-v // KC) * KC                        # zeros past V
    pad = lambda x: torch.nn.functional.pad(x, (0, v_pad - v))
    p = pad(flush(torch.exp2(a2 - m_a[..., None]), ftz))
    q = pad(flush(torch.exp2(l2 - m_l[..., None]), ftz))
    width = slice_width(v, n_split)
    s = torch.zeros(a.shape[0], a.shape[1], l.shape[1])
    for v_lo in range(0, v, width):                 # launch 2, one slice each
        v_end = min(v_pad, v_lo + width)
        halves = []
        for kw in (0, 1):
            cols = [c for c in range(v_lo, v_end) if (c - v_lo) % KC // 16 == kw]
            halves.append(product(p[..., cols], q[..., cols], ftz))
        s = s + (halves[0] + halves[1])             # launch 3: slices in order
    thr = math.ldexp(v, CERT_EXP)
    cert = s >= thr
    z = (m_a[:, :, None] + m_l[:, None, :] + torch.log2(s)) * LN2
    z = torch.where(cert, z, exact_pass(a2, l2))    # launch 4
    return z, ~cert, s, (a2, l2)


def truth_s(a2: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """S in float64 from the same log2-unit operands."""
    a2, l2 = a2.double(), l2.double()
    p = torch.exp2(a2 - a2.amax(-1, keepdim=True))
    q = torch.exp2(l2 - l2.amax(-1, keepdim=True))
    return p @ q.transpose(-1, -2)


def jax_refs(a: np.ndarray, l: np.ndarray):
    """The JAX package's XLA oracle and its Pallas kernel in interpret mode."""
    xla = np.asarray(additive_logz_xla(jnp.asarray(a), jnp.asarray(l)))
    pallas = np.asarray(_logz_pallas(jnp.asarray(a), jnp.asarray(l), interpret=True))
    return t(xla), t(pallas)


def test_split_is_tf32_rounding_on_the_bits():
    """The kernel's hi half is ``cvt.rna.tf32`` (the helpers' ``tf32_rna``)
    bit for bit, down into the subnormals; hi + lo carries the value to
    2^-21 where both halves are normal."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(4096), np.exp2(-rng.random(4096) * 149),
                        [1.0, 0.0, 2.0 ** -126, 2.0 ** -149, 1.0 - 2.0 ** -24]])
    x = torch.from_numpy(x.astype(np.float32))
    hi = split_hi(x)
    assert torch.equal(hi.view(torch.int32), tf32_rna(x).view(torch.int32))
    lo = tf32_rna(x - hi)
    normal = x >= 2.0 ** -100
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double())[normal]
    assert rel.max().item() <= 2.0 ** -21


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("v", [5, 37, 130])
@pytest.mark.parametrize("u1", [1, 6, 65])
@pytest.mark.parametrize("tlen", [1, 19, 70])
def test_schedule_matches_plain_xla_and_pallas(tlen, u1, v, n_split):
    rng = np.random.default_rng(tlen * 10000 + u1 * 100 + v)
    a = (rng.standard_normal((2, tlen, v)) * 3).astype(np.float32)
    l = (rng.standard_normal((2, u1, v)) * 3).astype(np.float32)
    got, marked, _, _ = emulate(t(a), t(l), n_split)
    assert not marked.any()                         # moderate logits: all certified
    torch.testing.assert_close(got, additive_logz_plain(t(a), t(l)), **TOL)
    xla, pallas = jax_refs(a, l)
    torch.testing.assert_close(got, xla, **TOL)
    torch.testing.assert_close(got, pallas, **TOL)


def spiked(rng, b, tlen, u1, v, margin):
    """randn * 3 logits with a peak ``margin`` nats above each spiked row's
    maximum: symbol 3 in the spiked rows of A, symbol 7 in those of L.
    Returns (A, L, spiked rows of A (B, T), spiked rows of L (B, U1))."""
    a = (rng.standard_normal((b, tlen, v)) * 3).astype(np.float32)
    l = (rng.standard_normal((b, u1, v)) * 3).astype(np.float32)
    sa = rng.random((b, tlen)) < 0.5
    sl = rng.random((b, u1)) < 0.5
    sa[0, 0], sl[0, 0], sa[-1, -1], sl[-1, -1] = True, True, False, False
    a[..., 3] = np.where(sa, a.max(-1) + margin, a[..., 3])
    l[..., 7] = np.where(sl, l.max(-1) + margin, l[..., 7])
    return a, l, torch.from_numpy(sa), torch.from_numpy(sl)


@pytest.mark.parametrize("ftz", [False, True])
@pytest.mark.parametrize("v", [37, 130])
@pytest.mark.parametrize("margin", [0, 30, 55, 62, 100, 1000])
def test_spiked_inputs_split_between_the_certificate_and_the_exact_pass(margin, v, ftz):
    rng = np.random.default_rng(margin + v)
    a, l, sa, sl = spiked(rng, 2, 19, 6, v, margin)
    got, marked, s, (a2, l2) = emulate(t(a), t(l), 2, ftz)
    torch.testing.assert_close(got, additive_logz_plain(t(a), t(l)), **TOL)
    xla, _ = jax_refs(a, l)
    torch.testing.assert_close(got, xla, **TOL)

    both = sa[:, :, None] & sl[:, None, :]          # peaks on different symbols
    if margin <= 30:
        assert not marked.any()
    if margin >= 100:                               # exactly the cells peaked twice
        assert torch.equal(marked, both)
    assert not (marked & ~both).any()
    # the certificate against S in float64: the same verdict away from the
    # threshold, and where it holds, S is the product's to 2^-16
    s64 = truth_s(a2, l2)
    ratio = torch.log2(s64 / math.ldexp(v, CERT_EXP))
    far = ratio.abs() > 0.01
    assert torch.equal(marked[far], (ratio < 0)[far])
    ok = ~marked
    rel = ((s[ok].double() - s64[ok]).abs() / s64[ok])
    assert rel.max().item() <= 2.0 ** -16
