"""The harness's data files, its traffic generator and its work counts, on
the CPU."""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark.mix import Mix, feature_frames, frame_budget
from benchmark.tests.tiny import PARKED
from benchmark.work import counts

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
ENTRIES = dict({w["name"]: w for w in SPEC["workloads"]}, **PARKED)
CELLS = list(ENTRIES)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_file_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_file_is_found_by_name(cell):
    entry = ENTRIES[cell]
    assert cell == f"{entry['config']}.{entry['traffic']}"
    workload = harness.load_json("workloads", cell)
    # the cell's file holds its limits alone: the rest is BENCHMARK.json's
    assert set(workload) == {"limits"}
    traffic = harness.load_json("traffic", entry["traffic"])
    module = harness.load_module("entries", traffic["entry"])
    assert all(callable(getattr(module, f)) for f in ("setup", "window", "check"))
    cfg = harness.load_json("configs", entry["config"])
    assert cfg["precision"] == "float32" and cfg["reduced"] == []
    assert set(workload["limits"]) and all(v > 0 for v in workload["limits"].values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_every_config_file_is_found_by_name(config):
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    cfg = json.loads((BENCH.parent / config["file"]).read_text())
    assert cfg["reduced"] == config["reduced"]
    enc = cfg["model"]["enc"]
    assert enc["d_model"] == cfg["data"]["feature_dim"] * (
        1 + cfg["data"]["left_context_width"] + cfg["data"]["right_context_width"])


@pytest.mark.parametrize("metric", sorted(p.name[:-3] for p in (BENCH / "metrics").glob("*.py")))
def test_every_metric_file_is_found_by_name(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_every_listed_metric_has_a_file():
    names = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert {m["name"] for m in SPEC["per_layer"]} <= names


@pytest.mark.parametrize("piece", sorted(p.stem for p in (BENCH / "work").glob("*_*.py")
                                            if not p.stem.startswith("_")))
def test_every_work_file_has_counts_and_patterns(piece):
    assert callable(harness.load_module("work", piece).count)
    assert list((BENCH / "work" / "patterns").glob(piece + ".*.txt"))


def mix(seed, batch=256):
    utt = harness.load_json("traffic", "recognize_b256")["utterances"]
    return Mix(utt, batch, 410, 3, 6485, seed)


def test_traffic_is_the_same_for_the_same_seed():
    a, b = mix(2 ** 31 + 7, 16).utterances(3), mix(2 ** 31 + 7, 16).utterances(3)
    c = mix(2 ** 31 + 8, 16).utterances(3)
    assert all(np.array_equal(x.wave, y.wave) and np.array_equal(x.labels, y.labels)
               for x, y in zip(a, b))
    assert not all(np.array_equal(x.wave, y.wave) for x, y in zip(a, c))


def test_every_seed_and_batch_asks_for_the_same_work():
    sizes = lambda m, i: sorted((len(u.wave), len(u.labels)) for u in m.utterances(i))
    assert sizes(mix(1, 32), 0) == sizes(mix(1, 32), 5) == sizes(mix(99, 32), 2)


def test_durations_and_labels_are_aishell_like():
    m = mix(5)
    seconds = m.samples / 16000
    assert abs(seconds.mean() - 4.5) < 0.1
    assert seconds.min() >= 1.8 and seconds.max() <= m.cap / 16000
    frames = feature_frames(m.samples, 410, 3)
    assert frames.min() >= 60 and frames.max() <= 410
    assert abs(m.n_labels.sum() / seconds.sum() - 3.2) < 0.1
    assert m.n_labels.min() >= 1 and m.n_labels.max() <= 42
    labels = np.concatenate([u.labels for u in m.utterances(0)])
    assert labels.min() >= 1 and labels.max() < 6485


def test_frame_budget_is_the_loaders():
    from transformer_transducer_tpu_torch.ops.features import feature_lengths, padded_wave_samples
    assert frame_budget(410, 3) == padded_wave_samples(410, 3)
    n = np.array([28800, 72000, 196320])
    assert feature_frames(n, 410, 3).tolist() == feature_lengths(n, 410, 3).tolist()


def test_work_counts_match_hand_arithmetic():
    u = {"t": 100, "t_pad": 410, "u": 9, "raw": 300}
    h, dh = 8, 64
    # full context: 100 query rows x 410 keys, 6 Dh a cell a head
    f, b = counts.attention_fwd(u, h, dh, None)
    assert f == 6 * 64 * 8 * 100 * 410
    tables = 410 * 8 * 64 + 8 * 64 + 410 * 8
    assert b == 4 * (8 * 64 * (2 * 100 + 2 * 410) + tables)
    # the band (10, 2): row i sees i-10 .. i+2 within the padded frames
    cells = sum(min(409, i + 2) - max(0, i - 10) + 1 for i in range(100))
    assert cells == 100 * 13 - sum(10 - i for i in range(10))
    f, b = counts.attention_bwd(u, h, dh, (10, 2))
    assert f == 16 * 64 * 8 * cells
    assert b == 4 * (8 * 64 * (3 * 100 + 4 * 102) + 2 * tables)
    model = {"enc": {"d_model": 512}, "dec": {"d_model": 512},
             "joint": {"inner_size": 2048}, "vocab_size": 6485}
    assert counts.joint_fwd(100, 10, 1000, model) == (
        2 * 2048 * (100 * 512 + 10 * 512) + 2 * 2048 * 6485 * 1000)
    assert counts.simple_joint_fwd(100, 10, model) == (
        2 * 2048 * (100 * (512 + 6485) + 10 * (512 + 6485)) + 2 * 6485 * 100 * 10)
    cfg = {"model": model, "encoder": "flash"}
    for part in ("enc", "dec"):
        model[part].update(n_layer=0, n_head=8, d_head=64, d_inner=2048)
    assert counts.train_fwd(u, cfg, 5) - counts.train_fwd(u, cfg) == (
        counts.simple_joint_fwd(100, 10, model) - 2 * 2048 * 6485 * 100 * 5)
    assert counts.layer_products(10, 512, 8, 64, 2048) == 2 * 10 * (
        512 * 1536 + 512 * 512 + 2 * 512 * 2048)
    assert counts.frontend(u) == 300 * (2.5 * 512 * 9 + 3 * 257 + 2 * 257 * 128)


def test_roofline_and_kernel_time_from_patterns():
    ctx = harness.Context("c", {}, {"encoder": "flash", "data": {"max_input_length": 410,
                                                                    "subsample": 3},
                                    "model": {"enc": {"n_head": 8, "d_head": 64, "n_layer": 2}}},
                          {}, 0, None, harness.Spans(False, None))
    run = harness.Run(ctx, [{"samples": [47840], "tokens": [3]}], 1.0,
                      kernels={"void flash_fwd_tc<64>(Args)": 2e-3, "ampere_sgemm": 1.0})
    assert run.kernel_seconds("flash_attn_fwd") == 2e-3
    assert run.kernel_seconds("banded_attn_fwd") is None
    u = counts.utterances(ctx.cfg, run.records[0])[0]
    assert u["t"] == 100
    f, b = counts.attention_fwd(u, 8, 64, None)
    least = 2 * max(f / harness.PEAK_FLOP_PER_S, b / harness.PEAK_BYTES_PER_S)
    assert math.isclose(run.roofline_pct("flash_attn_fwd"), 100 * least / 2e-3)
    assert run.roofline_pct("flash_attn_fwd", "flash_attn_bwd") is None


@pytest.mark.parametrize("seed", [2 ** 31 + 41, 2 ** 31 + 42, 2 ** 31 + 43])
def test_the_gated_blank_emits_at_the_traffic_rate(seed):
    from benchmark.entries import recognize
    from benchmark.tests.tiny import shrink
    cfg = harness.load_json("configs", "tt_offline8")
    traffic = harness.load_json("traffic", "recognize_b256")
    shrink(cfg, traffic)
    traffic.update(batch=32, pool_batches=2, warmup_batches=0)
    ctx = harness.Context("c", {}, cfg, traffic, seed, __import__("torch").device("cpu"),
                          harness.Spans(False, None))
    s = recognize.setup(ctx)
    for _ in range(2):
        recognize.one_batch(ctx, s)
    frames = sum(int(feature_frames(h["inputs_length"], 40, 3).sum()) for h in s.host)
    tokens = sum(len(x) for _, lists in s.served for x in lists)
    # batch 0 sets the bias; batch 1 is new audio, and histories move on
    assert abs(tokens / frames - recognize.emit_share(ctx)) < 0.06
