"""Operations and bytes that a batch's inputs need, by the model's
semantics: the arithmetic of the bound columns of the port's kernel table,
on true lengths.

Query frames, label positions, joint cells and greedy steps count at each
utterance's true length, not at the padding the program computes; padded
keys count only where the semantics attend to them (the unmasked encoder
attends to its batch's padded frames, under the streaming band to the
padded frames within the band).  Each input byte counts as read once and
each output byte as written once.  So a program that stops computing
padding shows as a gain here, and the counts never follow what the
program chooses to compute.  Products count 2 operations a multiply-add.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

from benchmark.mix import feature_frames

Shape = Dict  # one utterance: t (true frames), t_pad, u (labels or tokens), raw (log-mel frames)


def utterances(cfg: Dict, record: Dict) -> List[Shape]:
    """The utterances of one step or batch of the window's records."""
    data = cfg["data"]
    t_pad, factor = data["max_input_length"], data["subsample"]
    t = feature_frames(record["samples"], t_pad, factor)
    u = record.get("labels", record.get("tokens"))
    return [{"t": int(tb), "t_pad": t_pad, "u": int(ub), "raw": 1 + n // 160}
            for tb, ub, n in zip(t, u, record["samples"])]


def band_of(cfg: Dict) -> Optional[Tuple[int, int]]:
    if cfg["encoder"] != "banded":
        return None
    enc = cfg["model"]["enc"]
    return enc["left_context"], enc["right_context"]


def attention_cells(t: int, t_pad: int, band: Optional[Tuple[int, int]]) -> int:
    """Score cells of one head over ``t`` query rows: every key of the
    padded batch, or the keys within the band (padded keys too)."""
    if band is None:
        return t * t_pad
    left, right = band
    return sum(min(t_pad - 1, i + right) - max(0, i - left) + 1 for i in range(t))


def key_rows(t: int, t_pad: int, band: Optional[Tuple[int, int]]) -> int:
    """Key and value rows the ``t`` query rows read."""
    return t_pad if band is None else min(t + band[1], t_pad)


def _tables(t_pad: int, h: int, dh: int) -> int:
    return t_pad * h * dh + h * dh + t_pad * h       # r_emb, r_w_bias, r_bias


def attention_fwd(u: Shape, h: int, dh: int, band) -> Tuple[float, float]:
    """(operations, bytes) of one layer's attention forward of one
    utterance: 2 Dh each for AC, BD and AV a live cell; q and the output
    at the true rows, k and v at the key rows, the tables once."""
    cells = attention_cells(u["t"], u["t_pad"], band)
    kv = key_rows(u["t"], u["t_pad"], band)
    elems = h * dh * (2 * u["t"] + 2 * kv) + _tables(u["t_pad"], h, dh)
    return 6.0 * dh * h * cells, 4.0 * elems


def attention_bwd(u: Shape, h: int, dh: int, band) -> Tuple[float, float]:
    """(operations, bytes) of one layer's attention backward of one
    utterance: about 16 Dh a live cell (the scores again, dp, dv, dk, dq
    from AC and BD, the tables' gradients); q, dO and dq at the true rows,
    k, v, dk and dv at the key rows, the tables read and their gradients
    written once."""
    cells = attention_cells(u["t"], u["t_pad"], band)
    kv = key_rows(u["t"], u["t_pad"], band)
    elems = h * dh * (3 * u["t"] + 4 * kv) + 2 * _tables(u["t_pad"], h, dh)
    return 16.0 * dh * h * cells, 4.0 * elems


def layer_products(rows: int, d: int, h: int, dh: int, d_inner: int) -> float:
    """Operations of a layer's projections over ``rows`` rows: qkv, the
    output projection and the two feed-forward products."""
    return 2.0 * rows * (d * 3 * h * dh + h * dh * d + 2 * d * d_inner)


def encoder_fwd(u: Shape, enc: Dict, band) -> float:
    per_layer = (layer_products(u["t"], enc["d_model"], enc["n_head"], enc["d_head"],
                                enc["d_inner"])
                 + attention_fwd(u, enc["n_head"], enc["d_head"], band)[0])
    return enc["n_layer"] * per_layer


def labels_fwd(positions: int, dec: Dict) -> float:
    """The label encoder over ``positions`` causal positions."""
    cells = positions * (positions + 1) // 2
    return dec["n_layer"] * (layer_products(positions, dec["d_model"], dec["n_head"],
                                            dec["d_head"], dec["d_inner"])
                             + 6.0 * dec["d_head"] * dec["n_head"] * cells)


def joint_fwd(frames: int, positions: int, cells: int, model: Dict) -> float:
    """The joint over ``cells`` (frame, label position) cells: each frame's
    and each position's half of the first product once, the output product
    a cell."""
    enc_d, dec_d = model["enc"]["d_model"], model["dec"]["d_model"]
    inner, v = model["joint"]["inner_size"], model["vocab_size"]
    return 2.0 * inner * (frames * enc_d + positions * dec_d) + 2.0 * inner * v * cells


def frontend(u: Shape, n_fft: int = 512, n_mels: int = 128) -> float:
    """The log-mel of one utterance: a real FFT (2.5 N log2 N), the power
    spectrum and the mel product a frame."""
    bins = n_fft // 2 + 1
    return u["raw"] * (2.5 * n_fft * math.log2(n_fft) + 3 * bins + 2.0 * bins * n_mels)


def simple_joint_fwd(frames: int, positions: int, model: Dict) -> float:
    """The linearized joint of the pruned loss: ``A = enc W1e W2`` a frame,
    ``L = (dec W1d + b1) W2`` a position, and the normaliser of ``A[t] +
    L[u]`` over the vocabulary a cell, as a product of their exponentials."""
    enc_d, dec_d = model["enc"]["d_model"], model["dec"]["d_model"]
    inner, v = model["joint"]["inner_size"], model["vocab_size"]
    return (2.0 * inner * (frames * (enc_d + v) + positions * (dec_d + v))
            + 2.0 * v * frames * positions)


def train_fwd(u: Shape, cfg: Dict, s_range: Optional[int] = None) -> float:
    """The forward of a training step for one utterance: the encoder, the
    label encoder over the blank and its labels, and the joint over its
    (t, u + 1) lattice, or, for the pruned loss of range ``s_range``, over
    ``s_range`` positions a frame beside the linearized joint."""
    model = cfg["model"]
    pos = u["u"] + 1
    common = encoder_fwd(u, model["enc"], band_of(cfg)) + labels_fwd(pos, model["dec"])
    if s_range is None:
        return common + joint_fwd(u["t"], pos, u["t"] * pos, model)
    return (common + joint_fwd(u["t"], pos, u["t"] * min(s_range, pos), model)
            + simple_joint_fwd(u["t"], pos, model))


def greedy(u: Shape, model: Dict) -> float:
    """The greedy loop of one utterance: the whole joint at each true frame,
    and a label-encoder step for the seed and for each emitted token over
    its history."""
    dec = model["dec"]
    enc_d, dec_d = model["enc"]["d_model"], dec["d_model"]
    inner, v = model["joint"]["inner_size"], model["vocab_size"]
    joint = u["t"] * 2.0 * inner * (enc_d + dec_d + v)
    steps = sum(dec["n_layer"] * (layer_products(1, dec_d, dec["n_head"], dec["d_head"],
                                                 dec["d_inner"])
                                  + 6.0 * dec["d_head"] * dec["n_head"] * (n + 1))
                for n in range(u["u"] + 1))
    return joint + steps


def each_layer_call(run, per_utt, training_only: bool = False) -> Iterator[Tuple[float, float]]:
    """(operations, bytes) of each record's attention call of one layer,
    times the layers: ``per_utt(u, h, dh, band)`` summed over its
    utterances."""
    cfg = run.ctx.cfg
    enc = cfg["model"]["enc"]
    for record in run.records:
        if training_only and "labels" not in record:
            continue
        f = b = 0.0
        for u in utterances(cfg, record):
            df, db = per_utt(u, enc["n_head"], enc["d_head"], band_of(cfg))
            f, b = f + df, b + db
        yield enc["n_layer"] * f, enc["n_layer"] * b
