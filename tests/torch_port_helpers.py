"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_port_*).

Both packages get the same inputs, made with numpy from a seed, and the same
weights: a JAX ``init`` tree, carried into the port by
``utils/convert.py::from_jax_params``.  Shapes are small: 2 encoder layers,
d_model 64, 4 heads x 16.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transformer_transducer_tpu.models.transducer import build_transducer as jax_build
from transformer_transducer_tpu.utils.config import Config as JaxConfig
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops.cuda.band_kernel import _shifted, band_alpha_group
from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import NEG, logaddexp
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params

# fp32 parity tolerances (ROADMAP "Tolerances"): same math, different
# summation order in the two frameworks
TOL = dict(rtol=2e-4, atol=2e-5)

N_MELS = 16          # 16 mels x (1 + 3 + 0) stacked frames = d_model 64
ENC_K_LEN = 120      # T in (120, 150] exercises the front-pad rule


def tiny_model_cfg(vocab: int = 50, enc_layers: int = 2,
                   share_embedding: bool = False) -> dict:
    return {
        "enc": {"n_layer": enc_layers, "max_input_length": ENC_K_LEN,
                "left_context": 10, "right_context": 2, "n_head": 4,
                "d_model": 64, "d_head": 16, "d_inner": 128},
        "dec": {"n_layer": 2, "max_target_length": 42, "n_head": 4,
                "d_model": 64, "d_head": 16, "d_inner": 128},
        "joint": {"inner_size": 64 if share_embedding else 96},
        "vocab_size": vocab,
        "share_embedding": share_embedding,
        "dropout": 0.0,
    }


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def jax_model(model_cfg: dict, flash: bool = False, seed: int = 0):
    """(JAX Transducer, numpy variables) with flax-initialised weights."""
    model = jax_build(JaxConfig(copy.deepcopy(model_cfg)), flash=flash)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 64)),
                           jnp.zeros((1, 4), jnp.int32))
    return model, to_numpy_tree(variables)


def port_model(model_cfg: dict, variables, flash: bool = False):
    """The port's model on the CPU with the JAX weights."""
    model = build_transducer(Config(copy.deepcopy(model_cfg)), flash=flash,
                             device="cpu")
    model.load_state_dict(from_jax_params(variables["params"]))
    return model


def tiny_espnet_cfg(input_layer=None, vocab: int = 40, d: int = 32, heads: int = 4,
                    enc_blocks: int = 2, dec_blocks: int = 2, d_in: int = None,
                    activation: str = "tanh", band=(3, 2, 2)) -> dict:
    """An espnet-schema ``model:`` block at test size (the family's marker
    is the ``mask`` block)."""
    blk = {"output_size": d, "attention_heads": heads, "linear_units": 2 * d,
           "dropout_rate": 0.0, "positional_dropout_rate": 0.0,
           "attention_dropout_rate": 0.0, "padding_idx": -1}
    return {
        "enc": {**blk, "input_size": d_in or d, "num_blocks": enc_blocks,
                "input_layer": input_layer},
        "dec": {**blk, "input_size": vocab, "num_blocks": dec_blocks,
                "input_layer": "embed"},
        "joint": {"vocab_size": vocab, "encoder_output_size": d,
                  "decoder_output_size": d, "joint_space_size": d + 8,
                  "joint_activation_type": activation},
        "mask": {"encoder_left_mask": band[0], "encoder_right_mask": band[1],
                 "decoder_left_mask": band[2]},
    }


def jax_espnet_model(model_cfg: dict, seed: int = 0):
    """(JAX EspnetTransducer, numpy variables) with flax-initialised weights."""
    from transformer_transducer_tpu.models.espnet_variant import build_espnet_transducer
    model = build_espnet_transducer(JaxConfig(copy.deepcopy(model_cfg)))
    enc = model_cfg["enc"]
    t0 = 32
    xs = (jnp.zeros((1, t0), jnp.int32) if enc["input_layer"] == "embed"
          else jnp.zeros((1, t0, enc["input_size"])))
    variables = model.init(jax.random.PRNGKey(seed), xs, jnp.asarray([t0]),
                           jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]))
    return model, to_numpy_tree(variables)


def port_espnet_model(model_cfg: dict, variables):
    """The port's espnet model on the CPU with the JAX weights."""
    from transformer_transducer_tpu_torch.models.espnet_variant import (
        build_espnet_transducer)
    model = build_espnet_transducer(Config(copy.deepcopy(model_cfg)), device="cpu")
    model.load_state_dict(from_jax_params(variables["params"]))
    return model


def espnet_train_config(root: str, vocab_path: str, csvs: dict, vocab_size: int = 12,
                        d: int = 16, input_layer=None, **model_kw) -> dict:
    """A whole espnet-schema config (data, training, optim as
    ``data_helpers.tiny_train_config``'s; the stacked features, 4 x
    ``feature_dim``, are the encoder's input)."""
    from data_helpers import tiny_train_config
    cfg = dict(tiny_train_config(root, vocab_path, csvs, d_model=d, vocab_size=vocab_size))
    cfg["model"] = tiny_espnet_cfg(input_layer, vocab=vocab_size, d=d, heads=2,
                                   enc_blocks=1, dec_blocks=1, d_in=d, **model_kw)
    cfg["data"] = {**cfg["data"], "ignore_id": 0}
    cfg["training"] = {**cfg["training"], "save_model": "esp_tiny"}
    return cfg


def bias_espnet_blank(variables, offset: float):
    """Shift the espnet joint's blank logit so only some frames emit."""
    out = copy.deepcopy(variables)
    out["params"]["joint"]["lin_out"]["bias"][0] += offset
    return out


def bias_blank(variables, offset: float):
    """Shift the joint's blank logit so only some frames emit."""
    out = copy.deepcopy(variables)
    out["params"]["joint"]["project_layer"]["bias"][0] += offset
    return out


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# The flash kernels' tile algebra (tests/test_torch_port_flash_*_tiles.py)
# ---------------------------------------------------------------------------

def bd_rows(tlen, o):
    """Table row of each offset o, or -1 (o == 1, or outside the table)."""
    row = torch.where(o <= 0, tlen - 1 + o, o - 2)
    return torch.where((o == 1) | (row < 0) | (row >= tlen), -1, row)


def gather_rows(table, rows):
    """table[rows] with zeros where rows == -1; table (T, H, ...)."""
    out = table[rows.clamp(min=0)]
    return out * (rows >= 0).view(-1, *([1] * (out.dim() - 1))).to(out.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round fp32 to 10 mantissa bits, to nearest with
    ties away from zero, on the bits (the low 13 bits become zero)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-0x80000000, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def tc_product(a: torch.Tensor, b: torch.Tensor, terms: str,
               acc: torch.Tensor = None, step: int = 8) -> torch.Tensor:
    """(..., M, K) . (..., K, N) as the kernels' mma.sync tiles compute it:
    an fp32 accumulator (``acc``, else zeros) that takes each ``step``-deep
    step's exact products (8 for m16n8k8 TF32, 16 for m16n8k16 bf16, whose
    operands are bf16 values and so their own TF32 hi); ``terms`` "3x" adds
    lo.hi + hi.lo + hi.hi of the split operands, "1x" hi.hi."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if terms == "3x" else [(a_hi, b_hi)]
    c = torch.zeros(*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]), a.shape[-2],
                    b.shape[-1], dtype=torch.float32) if acc is None else acc
    for k in range(0, a.shape[-1], step):
        for x, y in pairs:
            # products of two TF32 values are exact in fp64; the step's sum
            # enters the fp32 accumulator once
            c = c + (x[..., k:k + step].double() @ y[..., k:k + step, :].double()).float()
    return c


def bf16_step(x) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits), 0 at 0."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8) * (x != 0)


def hold_bf16(name, got, ref, slack, ref32=None, quarter=0.25):
    """``|got - ref| <= slack`` element by element and, with ``ref32`` (the
    float32 result on the same bf16 values), ``||got - ref|| <= quarter *
    ||ref - ref32||``: the rounding points are ``ref``'s."""
    got, ref = (np.asarray(x, np.float32) for x in (got, ref))
    err = np.abs(got - ref)
    bad = err > slack
    assert not bad.any(), (f"{name}: {bad.sum()} elements over the bar, the worst "
                           f"{err.max():.3e}")
    if ref32 is not None:
        dist = np.linalg.norm(ref - np.asarray(ref32, np.float32))
        e2 = np.linalg.norm(got - ref)
        assert e2 <= quarter * dist, \
            f"{name}: error {e2:.3e} over {quarter} of the bf16-float32 distance {dist:.3e}"


def flip_allowance(scores: torch.Tensor, v) -> np.ndarray:
    """One bf16 step of each row's largest probability times max|v|, (B, T,
    H, 1) from the scores (B, H, T, T): what a P at a rounding boundary that
    rounds the other way moves its output row by."""
    p_max = torch.softmax(scores.float(), -1).amax(-1).transpose(1, 2)[..., None]
    return bf16_step(p_max.numpy()) * float(np.abs(np.asarray(v)).max())


# ---------------------------------------------------------------------------
# The band kernels' chunked schedule (tests/test_torch_port_band_*_chunks.py)
# ---------------------------------------------------------------------------

def band_problem(tlen, s_range, seed=0, b=3):
    """(lp_b, lp_l, d_alpha, rs, u_len) as numpy for ``b`` sequences:
    log-probs, label cells past a random u_len at NEG (sequence 1 has no
    labels: all at NEG), monotone band steps in [0, S) and the band starts
    rs they climb; sequence 2 also has the shifts -1 and S."""
    r = np.random.RandomState(seed + 100 * tlen + s_range)
    lp_b = np.log(r.uniform(0.05, 1.0, (b, tlen, s_range))).astype(np.float32)
    lp_l = np.log(r.uniform(0.05, 1.0, (b, tlen, s_range))).astype(np.float32)
    steps = r.randint(0, s_range, (b, tlen))
    steps[:, 0] = 0
    rs = np.cumsum(steps, axis=1)
    u_len = rs[:, -1] + r.randint(0, s_range, (b,))
    u_len[1] = 0
    uidx = rs[:, :, None] + np.arange(s_range)
    lp_l = np.where(uidx < u_len[:, None, None], lp_l, NEG).astype(np.float32)
    d = steps.astype(np.int32)
    if tlen > 3:
        d[2, 1], d[2, tlen // 2] = -1, s_range
    return lp_b, lp_l, d, rs, u_len


def label_scan(c, lp_l_row, reverse=False):
    """The in-row label chain as the kernels' scan over slots (S <= 32):
    (w, v) = (lp_l of the edge into the slot, the value), each element
    combined with the one o slots back along the chain as (w, v) <- (w +
    w_o, lae(v, v_o + w)) at o = 1, 2, 4, ...  The alpha's chain climbs the
    slots (w = lp_l of the slot below); ``reverse``, the beta's, descends
    them (w = the slot's own lp_l): the alpha's on the flipped slots."""
    if reverse:
        flip = lambda x: x.flip(-1)
        l = flip(lp_l_row)
        return flip(label_scan(flip(c), torch.cat([l[..., 1:], l[..., :1]], dim=-1)))
    s_range = c.shape[-1]
    w = torch.cat([lp_l_row[..., :1], lp_l_row[..., :-1]], dim=-1)
    v, o = c, 1
    while o < s_range:
        vo = torch.cat([v[..., :o], v[..., :-o]], dim=-1)
        wo = torch.cat([w[..., :o], w[..., :-o]], dim=-1)
        on = torch.arange(s_range) >= o
        v = torch.where(on, logaddexp(v, vo + w), v)
        w = torch.where(on, w + wo, w)
        o *= 2
    return v


def label_chain(a, lp_l_row, reverse=False):
    """The row's label chain: the scan at S <= 32, slot by slot beyond."""
    s_range = a.shape[-1]
    if s_range <= 32:
        return label_scan(a, lp_l_row, reverse)
    cols = list(a.unbind(-1))
    if reverse:
        for s in range(s_range - 2, -1, -1):
            cols[s] = logaddexp(cols[s], lp_l_row[..., s] + cols[s + 1])
    else:
        for s in range(1, s_range):
            cols[s] = logaddexp(cols[s], cols[s - 1] + lp_l_row[..., s - 1])
    return torch.stack(cols, dim=-1)


def renorm(a, k_off):
    """The kernels' renorm: the largest value of each state moves into its
    float64 offset, unless the whole state sits at NEG."""
    m = a.amax(dim=-1)
    ok = m > NEG / 2
    m = torch.where(ok, m, torch.zeros_like(m))
    return a - m[..., None], k_off + m.double()


def band_steps(a, lp_b, lp_l, d, rows, k_off=None, start=False, beta=False):
    """The kernels' steps over ``rows`` (row indices, in the sweep's order)
    from the state ``k_off + a`` (B, K, S) of the step before, renormalised
    after every 8th step.  The alpha's blank edge brings slot s + d[t] of
    the row before plus its lp_b, the beta's (``beta``) slot s - d[t] of
    the row after, lp_b[t] added where it lands (NEG for a shift outside
    [0, S)); with ``start`` the first step is the sweep's first, with no
    edge in (the alpha keeps its start; the beta adds lp_b: the terminal
    injection).  Returns the rows (B, K, len(rows), S) in float32 and the
    final state (a, k_off)."""
    b, k, s_range = a.shape
    if k_off is None:
        k_off = torch.zeros(b, k, dtype=torch.float64)
    out = []
    for i, t in enumerate(rows):
        first = start and i == 0
        if not first:
            x = a if beta else a + lp_b[:, None, t - 1]
            a = _shifted(x.reshape(b * k, s_range), d[:, t].repeat_interleave(k),
                         -1 if beta else 1).reshape(b, k, s_range)
        if beta:
            a = a + lp_b[:, None, t]
        a = label_chain(a, lp_l[:, None, t], reverse=beta)
        out.append((k_off[..., None] + a.double()).float())
        if i % 8 == 7:
            a, k_off = renorm(a, k_off)
    rows_out = torch.stack(out, dim=2) if out else a.new_zeros(b, k, 0, s_range)
    return rows_out, a, k_off


def boundary(p, e):
    """max(NEG, P (x) E): ``p`` (B, K, S) holds P[s][k] at [:, k, s], ``e``
    (B, S) the state; the largest of the S terms, then their exponentials
    summed over k in order, as the kernels' phase B."""
    terms = p + e[:, :, None]                      # (B, k, s)
    m = terms.amax(dim=1)
    total = torch.zeros_like(m)
    for k in range(terms.shape[1]):
        total = total + torch.exp(terms[:, k] - m)
    return torch.clamp(m + torch.log(total), min=NEG)


def boundaries(e0, transfer, n_chunks):
    """E_0 .. E_n from E_0 and P_1 .. P_n: with ``n_chunks``, the kernels'
    two levels over groups of H = ``band_alpha_group(C)`` (B1: each group's
    composite from the unit vectors; B2: its end states from E_0; B3: the
    states inside each group); without, one boundary after another."""
    if n_chunks is None or not transfer:
        ends = [e0]
        for p in transfer:
            ends.append(boundary(p, ends[-1]))
        return ends
    b, s_range = e0.shape
    h = band_alpha_group(n_chunks)
    groups = [transfer[i:i + h] for i in range(0, len(transfer), h)]
    unit = torch.full((s_range, s_range), NEG).fill_diagonal_(0.0)
    composite = []                                     # B1
    for group in groups:
        q = unit.expand(b, s_range, s_range)           # [:, k, s]
        for p in group:
            q = torch.stack([boundary(p, q[:, k]) for k in range(s_range)], dim=1)
        composite.append(q)
    starts = [e0]                                      # B2
    for q in composite:
        starts.append(boundary(q, starts[-1]))
    ends = [e0]                                        # B3
    for g, group in enumerate(groups):
        e = starts[g]
        for p in group[:-1]:
            e = boundary(p, e)
            ends.append(e)
        ends.append(starts[g + 1])
    return ends


# ---------------------------------------------------------------------------
# The lattice sweeps' warp schedule (tests/test_torch_port_lattice_warp.py)
# ---------------------------------------------------------------------------

def lattice_problem(tlen, u1, seed=0, b=4):
    """(sb, sl, terminal, inject) for ``b`` sequences as the loss builds them
    (the port's ``lattice_grids`` and ``terminal_inject``) from log-probs
    drawn with numpy: sequence 0 at full length, sequence 1 with no frames,
    the rest of random lengths."""
    from transformer_transducer_tpu_torch.ops import rnnt_loss
    r = np.random.RandomState(seed + 1000 * tlen + u1)
    logits = r.randn(b, tlen, u1, 8).astype(np.float32) * 2
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    t_len = r.randint(1, tlen + 1, b)
    u_len = r.randint(0, u1, b)
    t_len[0], u_len[0] = tlen, u1 - 1
    t_len[1] = 0
    sb, sl, t_len, u_len = rnnt_loss.lattice_grids(t(logp[..., 0]), t(logp[..., 1]),
                                                   t(t_len), t(u_len))
    terminal, inject = rnnt_loss.terminal_inject(sb, t_len, u_len)
    return sb, sl, terminal, inject


def copy_items(n, shift):
    """The kernel's ``copy_span`` of ``n`` floats from a source at float
    index ``shift`` mod 4: its work items in order, each (first float,
    floats), 1 up to the first 16-byte boundary and after the last, 4
    between."""
    head = min((4 - shift) & 3, n)
    n16 = (n - head) >> 2
    return [(head + 4 * (k - head), 4) if head <= k < head + n16
            else (k if k < head else k + 3 * n16, 1)
            for k in range(n - 3 * n16)]
