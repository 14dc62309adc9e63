"""The plain reference against the program's CPU path, on the same weights
and inputs, at a tiny size (2 layers, d_model 64).  The only file that
imports both."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.mix import Mix
from benchmark.reference import features as F
from benchmark.reference import greedy as G
from benchmark.reference import model as M
from benchmark.reference.rnnt import batch_loss, batch_loss_pruned
from benchmark.tests.tiny import shrink
from transformer_transducer_tpu_torch.data.dataset import pad_raw_wave
from transformer_transducer_tpu_torch.decoding.greedy import greedy_decode, tokens_to_lists
from transformer_transducer_tpu_torch.models.factory import build_family
from transformer_transducer_tpu_torch.ops.features import extract_batch_padded
from transformer_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss_fused
from transformer_transducer_tpu_torch.ops.rnnt_loss_pruned import (
    pruned_bounds, rnnt_loss_pruned, simple_grid_logprobs)
from transformer_transducer_tpu_torch.utils.config import Config


def tiny(config: str):
    cfg = harness.load_json("configs", config)
    traffic = harness.load_json("traffic", "train_full_b16")
    shrink(cfg, traffic)
    traffic["batch"] = 4
    return cfg, traffic


def setup(config: str, seed: int = 3):
    cfg, traffic = tiny(config)
    data = cfg["data"]
    mix = Mix(traffic["utterances"], traffic["batch"], data["max_input_length"],
              data["subsample"], cfg["model"]["vocab_size"], seed)
    utts = mix.utterances(0)
    w = weights.make(weights.spec(cfg["model"]), seed, "cpu")
    model = build_family(Config(cfg), device="cpu", flash=cfg["encoder"] == "flash",
                         banded=cfg["encoder"] == "banded")
    model.load_state_dict(w)
    waves, counts = zip(*(pad_raw_wave(u.wave, mix.cap, mix.total) for u in utts))
    waves = torch.as_tensor(np.stack(waves))
    counts = torch.as_tensor(np.asarray(counts))
    return cfg, utts, w, model, waves, counts


@pytest.mark.parametrize("variant", ["eps", "masked"])
def test_features(variant):
    cfg, utts, _, _, waves, counts = setup("tt_stream18")
    d = cfg["data"]
    got, t_len = extract_batch_padded(waves, counts, d["max_input_length"],
                                      n_mels=d["feature_dim"], left=3, right=0, factor=3,
                                      log_variant=variant)
    ref = F.features([u.wave for u in utts], variant, d["max_input_length"], 3, 0, 3, "cpu",
                     d["feature_dim"])
    assert t_len.tolist() == [F.frames(len(u.wave), d["max_input_length"], 3) for u in utts]
    # the program's float32 FFT against the float64 pipeline
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("config", ["tt_stream18", "tt_offline8"])
def test_encoders_and_joint(config):
    cfg, _, w, model, _, _ = setup(config)
    torch.manual_seed(0)
    feats = torch.randn(4, cfg["data"]["max_input_length"], cfg["model"]["enc"]["d_model"])
    band = (10, 2) if config == "tt_stream18" else None
    got, _ = model.encode_for_decoding(feats, None, band=band)
    torch.testing.assert_close(got, M.encode_audio(feats, w, cfg["model"]["enc"], band),
                               atol=2e-5, rtol=1e-5)
    targets = torch.randint(1, cfg["model"]["vocab_size"], (4, 8))
    dec = model.encode_labels(targets)
    ref_dec = M.encode_labels(torch.nn.functional.pad(targets, (1, 0)), w, cfg["model"]["dec"])
    torch.testing.assert_close(dec, ref_dec, atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(model.joint_logits(got, dec),
                               M.joint_logits(got[:, :, None], dec[:, None], w),
                               atol=2e-5, rtol=1e-5)


def test_loss_and_its_gradients():
    cfg, utts, w, model, _, _ = setup("tt_stream18")
    torch.manual_seed(1)
    t, d = cfg["data"]["max_input_length"], cfg["model"]["enc"]["d_model"]
    enc = torch.randn(4, t, d, requires_grad=True)
    dec = torch.randn(4, 9, d, requires_grad=True)
    targets = torch.zeros(4, 8, dtype=torch.long)
    u_len = [len(u.labels) for u in utts]
    for i, u in enumerate(utts):
        targets[i, :len(u.labels)] = torch.as_tensor(u.labels)
    t_len = [37, 40, 12, 25]
    loss = rnnt_loss_fused(enc, dec, model.joint_params(), targets, torch.tensor(t_len),
                           torch.tensor(u_len))
    joint = [n for n in w if n.startswith("joint.")]
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss, [enc, dec] + [params[n] for n in joint])
    for n in joint:
        w[n].requires_grad_(True)
    ref_loss, d_enc, d_dec, d_joint = batch_loss(enc.detach(), dec.detach(), targets, t_len,
                                                 u_len, w, joint)
    torch.testing.assert_close(loss.detach(), ref_loss, atol=1e-4, rtol=1e-5)
    for g, r in zip(got, [d_enc, d_dec] + [d_joint[n] for n in joint]):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("s_range", [2, 3, 5])
def test_pruned_loss_its_bands_and_its_gradients(s_range):
    cfg, utts, w, model, _, _ = setup("tt_offline8", seed=5)
    torch.manual_seed(2)
    t, d = cfg["data"]["max_input_length"], cfg["model"]["enc"]["d_model"]
    enc = torch.randn(4, t, d, requires_grad=True)
    dec = torch.randn(4, 9, d, requires_grad=True)
    targets = torch.zeros(4, 8, dtype=torch.long)
    u_len = [len(u.labels) for u in utts]
    for i, u in enumerate(utts):
        targets[i, :len(u.labels)] = torch.as_tensor(u.labels)
    t_len = [37, 40, 12, 25]
    jp = model.joint_params()
    loss = rnnt_loss_pruned(enc, dec, jp, targets, torch.tensor(t_len), torch.tensor(u_len),
                            s_range=s_range, simple_scale=0.25)
    joint = [n for n in w if n.startswith("joint.")]
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss, [enc, dec] + [params[n] for n in joint])
    for n in joint:
        w[n].requires_grad_(True)
    ref_loss, d_enc, d_dec, d_joint, starts = batch_loss_pruned(
        enc.detach(), dec.detach(), targets, t_len, u_len, w, joint, s_range, 0.25)
    with torch.no_grad():
        grids = simple_grid_logprobs(enc, dec, jp, targets)
        rs = pruned_bounds(*grids, torch.tensor(t_len), torch.tensor(u_len), s_range)
    assert [r[:n].tolist() for r, n in zip(rs, t_len)] == starts
    assert any(max(r) > 0 for r in starts)
    torch.testing.assert_close(loss.detach(), ref_loss, atol=1e-4, rtol=1e-5)
    # gradients summed over many cells of both lattices: float32 rounding
    # leaves about 1e-5 of each leaf's norm
    for g, r in zip(got, [d_enc, d_dec] + [d_joint[n] for n in joint]):
        assert float((g - r).norm()) <= 1e-4 * float(r.norm())


def test_served_greedy_tokens_read_no_gap_and_a_wrong_one_does():
    cfg, utts, w, model, waves, counts = setup("tt_offline8", seed=11)
    d = cfg["data"]
    feats, t_len = extract_batch_padded(waves, counts, d["max_input_length"],
                                        n_mels=d["feature_dim"], left=3, right=0, factor=3,
                                        log_variant="masked")
    enc, t_len = model.encode_for_decoding(feats, t_len)
    tokens, n = greedy_decode(model, enc, t_len, 8)
    lists = tokens_to_lists(tokens.numpy(), n.numpy())
    assert any(lists)
    ref_feats = F.features([u.wave for u in utts], "masked", d["max_input_length"], 3, 0, 3,
                           "cpu", d["feature_dim"])
    with torch.no_grad():
        ref_enc = M.encode_audio(ref_feats, w, cfg["model"]["enc"], None)
        dec = G.label_states(lists, w, cfg["model"]["dec"], "cpu")
        for k, toks in enumerate(lists):
            gb, gl, _ = G.decision_gaps(ref_enc[k, :t_len[k]], dec[k, :len(toks) + 1], toks, w)
            assert G.widest_gap(gb, gl, 8)[0] < 1e-4
        k = next(i for i, toks in enumerate(lists) if toks)
        wrong = list(lists[k])
        wrong[0] = wrong[0] % (cfg["model"]["vocab_size"] - 1) + 1
        dec = G.label_states([wrong], w, cfg["model"]["dec"], "cpu")
        gb, gl, _ = G.decision_gaps(ref_enc[k, :t_len[k]], dec[0], wrong, w)
        assert G.widest_gap(gb, gl, 8)[0] > 1e-3
