"""Offline recognition: int16 waves on the host to token lists on the host,
one batch after the other's tokens have arrived.

A batch goes to the card as the loader's on-device-features layout
(``training/train_step.py::batch_to_device``), through the log-mel
(``ops/features.py::extract_batch_padded``, the recognition log), the
encoder (``encode_for_decoding``: full context through the flash kernels
for a ``flash`` configuration, or the streaming band) and the greedy loop
(``decoding/greedy.py::greedy_decode``), and its tokens come back as lists
(``tokens_to_lists``), as ``decoding/greedy.py::recognize`` does.

The weights are seeded, with the blank gated (``weights.gate_blank``) and
its bias set from the plain reference at set-up, so that every seed's
model emits on about as many frames as a trained one does at the
traffic's characters a second: the greedy loop's label steps, which run
on each frame where any row emits, are then the same work for every seed.

``check`` frees the program and judges a sample of the served token
lists, drawn from the seed and holding the utterance with the most
tokens, by the widest gap between a served token's logit and the best
logit of the plain reference (``benchmark/reference/greedy.py``), and the
encoder states of the window's last batch, for a sample of its rows, by
their largest difference from the reference's over the reference's
largest magnitude.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.entries.train import host_batch, mix_of
from benchmark.mix import HOP, SAMPLE_RATE, feature_frames, seed_words


CALIBRATION_ROWS = 256     # utterances of the first batch that set the gate


class State:
    pass


def _band(cfg):
    if cfg["encoder"] != "banded":
        return None
    return (cfg["model"]["enc"]["left_context"], cfg["model"]["enc"]["right_context"])


def setup(ctx) -> State:
    from transformer_transducer_tpu_torch.data.dataset import pad_raw_wave
    from transformer_transducer_tpu_torch.models.factory import build_family
    from transformer_transducer_tpu_torch.utils.config import Config
    cfg, t = ctx.cfg, ctx.traffic
    s = State()
    s.mix = mix_of(ctx)
    s.pool = [s.mix.utterances(i) for i in range(t["pool_batches"])]
    s.host = [host_batch(s.mix, cfg["data"]["max_target_length"], u, pad_raw_wave)
              for u in s.pool]
    w = gated_weights(ctx, s)
    model = build_family(Config(cfg), device=ctx.device, flash=cfg["encoder"] == "flash")
    model.load_state_dict(w)
    del w
    s.model = model.eval()
    s.served, s.next = [], 0
    for _ in range(t["warmup_batches"]):
        one_batch(ctx, s)
    s.served, s.next = [], 0
    return s


def emit_share(ctx) -> float:
    """The share of frames on which a recogniser emits at the traffic's
    characters a second (a frame is ``subsample`` hops of 10 ms)."""
    frame_s = ctx.cfg["data"]["subsample"] * HOP / SAMPLE_RATE
    return ctx.traffic["utterances"]["chars_per_s"] * frame_s


def reference_encode(ctx, w, waves) -> torch.Tensor:
    """The plain reference's encoder states of host waves, in blocks."""
    from benchmark.reference import features as F
    from benchmark.reference import model as M
    data, t = ctx.cfg["data"], ctx.traffic
    out = []
    for lo in range(0, len(waves), t["check_block"]):
        feats = F.features(waves[lo:lo + t["check_block"]], "masked",
                           data["max_input_length"], data["left_context_width"],
                           data["right_context_width"], data["subsample"], ctx.device,
                           data["feature_dim"])
        out.append(M.encode_audio(feats, w, ctx.cfg["model"]["enc"], _band(ctx.cfg)))
    return torch.cat(out)


def gate_direction(rows: List[torch.Tensor], ridge: float = 0.1):
    """The direction along which the encoder states of a batch move most
    from frame to frame within an utterance against how far the
    utterances' means lie apart (a ridge-regularised discriminant of the
    rows' (n, D) true frames), so that a gate on it emits at about the
    same rate in every utterance; and the mean and standard deviation of
    the states along it."""
    rows = [r.double() for r in rows]
    means = torch.stack([r.mean(0) for r in rows])
    within = torch.cat([r - m for r, m in zip(rows, means)])
    w_cov = within.t() @ within / len(within)
    spread = means - means.mean(0)
    b_cov = spread.t() @ spread / len(means)
    # a trace's millionth keeps a batch of fewer frames than widths solvable
    floor = 1e-6 * w_cov.diagonal().mean() * torch.eye(len(w_cov), dtype=w_cov.dtype,
                                                        device=w_cov.device)
    l_inv = torch.linalg.inv(torch.linalg.cholesky(b_cov + ridge * w_cov + floor))
    _, vecs = torch.linalg.eigh(l_inv @ w_cov @ l_inv.t())
    u = l_inv.t() @ vecs[:, -1]
    u = (u / u.norm()).float()
    proj = torch.cat(rows).float() @ u
    return u, float(proj.mean()), float(proj.std())


@torch.no_grad()
def gated_weights(ctx, s: State):
    """The seeded weights with the blank gated (``weights.gate_blank``) on
    the plain reference's encoder states of the first ``CALIBRATION_ROWS``
    utterances of the pool's first batch, and its bias set so that the
    reference emits on ``emit_share`` of their true frames, each read with
    the history that a decoder emitting at that share holds there (the
    prefix of the row's traffic labels): about a trained model's rate, in
    every utterance and for every seed, and no row near the token budget.
    The gate is kept for ``check`` (``s.gate``)."""
    from benchmark import weights
    from benchmark.reference import features as F
    from benchmark.reference import greedy as G
    from benchmark.reference import model as M
    model_cfg, data = ctx.cfg["model"], ctx.cfg["data"]
    w = weights.make(weights.spec(model_cfg), seed_words(ctx.seed, 2), ctx.device)
    utts, share = s.pool[0][:CALIBRATION_ROWS], emit_share(ctx)
    enc = reference_encode(ctx, w, [u.wave for u in utts])
    lens = [F.frames(len(u.wave), data["max_input_length"], data["subsample"]) for u in utts]
    gate = gate_direction([enc[k, :n] for k, n in enumerate(lens)])
    weights.gate_blank(w, model_cfg, *gate)
    dec = G.label_states([u.labels.tolist() for u in utts], w, model_cfg["dec"], ctx.device)
    margins = []
    for k, (u, n) in enumerate(zip(utts, lens)):
        held = torch.clamp((torch.arange(n, device=ctx.device) * share).long(),
                           max=len(u.labels))
        logits = M.joint_logits(enc[k, :n], dec[k, held], w)
        margins.append(logits[:, 0] - logits[:, 1:].max(-1).values)
    # a frame emits where the blank's logit plus its bias is under the best label's
    w["joint.project_layer.bias"][0] = -float(torch.quantile(torch.cat(margins).double(),
                                                             share))
    s.gate = gate + (float(w["joint.project_layer.bias"][0]),)
    return w


def reference_weights(ctx, s: State):
    """The weights as set-up made them, again."""
    from benchmark import weights
    w = weights.make(weights.spec(ctx.cfg["model"]), seed_words(ctx.seed, 2), ctx.device)
    weights.gate_blank(w, ctx.cfg["model"], *s.gate[:3])
    w["joint.project_layer.bias"][0] = s.gate[3]
    return w


@torch.no_grad()
def one_batch(ctx, s: State):
    """The window's call: one host batch to token lists on the host, with
    no autograd graph, as ``recognize`` runs."""
    from transformer_transducer_tpu_torch.decoding import greedy
    from transformer_transducer_tpu_torch.ops.features import extract_batch_padded
    from transformer_transducer_tpu_torch.training.train_step import batch_to_device
    data = ctx.cfg["data"]
    index = s.next % len(s.host)
    host = s.host[index]
    with ctx.spans("encode"):
        batch = batch_to_device({"inputs": host["inputs"], "inputs_length": host["inputs_length"]},
                                ctx.device)
        feats, t_len = extract_batch_padded(
            batch["inputs"], batch["inputs_length"], data["max_input_length"],
            n_mels=data["feature_dim"], left=data["left_context_width"],
            right=data["right_context_width"], factor=data["subsample"], log_variant="masked")
        enc, t_len = s.model.encode_for_decoding(feats, t_len, band=_band(ctx.cfg))
    with ctx.spans("greedy"):
        tokens, counts = greedy.greedy_decode(s.model, enc, t_len, ctx.traffic["max_tokens"])
        lists = greedy.tokens_to_lists(tokens.cpu().numpy(), counts.cpu().numpy())
    s.served.append((index, lists))
    s.next += 1
    s.last_enc = enc


def window(ctx, s: State, seconds: float) -> Dict:
    t0 = time.perf_counter()
    while True:
        one_batch(ctx, s)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    records = [{"samples": s.host[i]["inputs_length"].tolist(),
                "tokens": [len(x) for x in lists]} for i, lists in s.served]
    n = len(s.served)
    data = ctx.cfg["data"]
    frames = sum(int(feature_frames(r["samples"], data["max_input_length"],
                                    data["subsample"]).sum()) for r in records)
    tokens = [k for r in records for k in r["tokens"]]
    print(f"served {sum(tokens)} tokens over {frames} frames: {sum(tokens) / frames:.4f} a "
          f"frame (aimed at {emit_share(ctx):.4f}); rows at the token budget: "
          f"{sum(k >= ctx.traffic['max_tokens'] - 1 for k in tokens)} of {len(tokens)}",
          file=sys.stderr)
    return {"records": records, "attempted": n * ctx.traffic["batch"],
            "failed": 0, "end_to_end": {"recognize_audio_x": n * s.mix.audio_seconds() / elapsed}}


def sample(ctx, served: List, n: int):
    """(pool index, row, tokens) of ``n`` served utterances drawn from the
    seed, the one with the most tokens first."""
    flat = [(i, r, toks) for i, lists in served for r, toks in enumerate(lists)]
    longest = max(range(len(flat)), key=lambda k: len(flat[k][2]))
    rng = np.random.default_rng(seed_words(ctx.seed, 5))
    rest = rng.choice(len(flat), size=min(n, len(flat)), replace=False).tolist()
    picks = [longest] + [k for k in rest if k != longest][:n - 1]
    return [flat[k] for k in picks]


def check(ctx, s: State, out: Dict):
    from benchmark import harness
    from benchmark.reference import features as F
    from benchmark.reference import greedy as G
    from benchmark.reference import model as M
    cfg, t = ctx.cfg, ctx.traffic
    data, model_cfg = cfg["data"], cfg["model"]
    picks = sample(ctx, s.served, t["check_utterances"])
    rng = np.random.default_rng(seed_words(ctx.seed, 6))
    last_index = s.served[-1][0]
    rows = sorted(rng.choice(t["batch"], size=t["check_states"], replace=False).tolist())
    enc_prog = s.last_enc[rows].detach().to("cpu", copy=True)
    del s.model, s.last_enc
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    w = reference_weights(ctx, s)
    frames = lambda wave: F.frames(len(wave), data["max_input_length"], data["subsample"])
    encode = lambda waves: reference_encode(ctx, w, waves)

    def enc_err(enc_a, enc_b, waves):
        worst = 0.0
        for k, wave in enumerate(waves):
            a, b = enc_a[k, :frames(wave)].cpu(), enc_b[k, :frames(wave)].cpu()
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        return worst

    state_waves = [s.pool[last_index][r].wave for r in rows]
    waves = [s.pool[i][r].wave for i, r, _ in picks]
    histories = [toks for _, _, toks in picks]
    with torch.no_grad():
        enc_ref = encode(state_waves)
        err = enc_err(enc_prog, enc_ref, state_waves)
        enc = encode(waves)
        dec = G.label_states(histories, w, model_cfg["dec"], ctx.device)
        firsts = None
        if getattr(ctx, "control", False):
            # the reference in TF32 in the program's place
            with harness.tf32():
                ctrl_err = enc_err(encode(state_waves), enc_ref, state_waves)
                enc_c = encode(waves)
                dec_c = G.label_states(histories, w, model_cfg["dec"], ctx.device)
                firsts = [M.joint_logits(enc_c[k, :frames(wv), None], dec_c[k, None, :len(h) + 1],
                                         w).argmax(-1)
                          for k, (wv, h) in enumerate(zip(waves, histories))]
        widest, widest_ctrl = 0.0, 0.0
        for k, toks in enumerate(histories):
            g_blank, g_label, g_ctrl = G.decision_gaps(
                enc[k, :frames(waves[k])], dec[k, :len(toks) + 1], toks, w,
                None if firsts is None else firsts[k])
            gap, ctrl = G.widest_gap(g_blank, g_label, t["max_tokens"], g_ctrl)
            widest = max(widest, gap)
            widest_ctrl = max(widest_ctrl, ctrl or 0.0)
    if firsts is not None:
        ctx.readings = {"token_gap": widest_ctrl, "enc_err": ctrl_err}
    limits = ctx.workload["limits"]
    return [("token_gap", widest, limits["token_gap"]), ("enc_err", err, limits["enc_err"])]

