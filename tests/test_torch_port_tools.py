"""PyTorch port: the host-side modules and tools, each held against the JAX
package's function or repo-root tool on the same seeded inputs:
``ops/vad.py`` (the LTSD VAD's decisions and spans equal), ``ops/misc.py``
(``label_smoothing``, ``save_spectrogram_image``), ``data/prep.py`` (the
six importers, manifests, the grapheme table, statistics, clipping and the
feature dump, equal to the byte where both write files),
``tools/average_checkpoints.py`` (over port checkpoints and JAX msgpack
ones, each leaf the float64 mean rounded to float32, integer leaves by
ESPnet's floor rule), ``tools/convert_checkpoint.py`` (a reference
``.chkpt``, both families, compared through ``from_jax_params``), the plot
tools (skipped without matplotlib) and ``tools/tone_demo.py``'s learning
run for one epoch on the CPU."""

import importlib.util
import json
import os
import sys

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_transducer_tpu.data import kaldiio as jax_kaldiio
from transformer_transducer_tpu.data import prep as jax_prep
from transformer_transducer_tpu.ops import features_np as jax_F
from transformer_transducer_tpu.ops import misc as jax_misc
from transformer_transducer_tpu.ops.vad import LtsdConfig as JaxLtsdConfig
from transformer_transducer_tpu.ops.vad import LtsdVad as JaxLtsdVad
from transformer_transducer_tpu.utils import checkpoint as jax_ckpt
from transformer_transducer_tpu_torch.data import kaldiio, prep
from transformer_transducer_tpu_torch.data.wav import write_wave
from transformer_transducer_tpu_torch.models.espnet_variant import build_espnet_transducer
from transformer_transducer_tpu_torch.models.factory import load_family
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops import misc
from transformer_transducer_tpu_torch.ops.vad import LtsdConfig, LtsdVad
from transformer_transducer_tpu_torch.tools import (
    average_checkpoints, convert_checkpoint, plot_features, plot_training, tone_demo)
from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import from_jax_params, random_jax_params

from torch_port_helpers import tiny_espnet_cfg, tiny_model_cfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wav(path, n=3200, seed=0):
    rng = np.random.RandomState(seed)
    write_wave(str(path), (rng.randn(n) * 3000).astype(np.int16))
    return str(path)


# ---------------------------------------------------------------------------
# ops/vad.py, ops/misc.py
# ---------------------------------------------------------------------------

def _speech_in_noise(seed, zero_tail=False):
    rng = np.random.RandomState(seed)
    sr = 16000
    noise = rng.randn(2 * sr) * 60
    t = np.arange(sr // 2) / sr
    voiced = 3000 * np.sin(2 * np.pi * (150 + 80 * t) * t) * (1 + np.sin(2 * np.pi * 3 * t))
    signal = noise.copy()
    start = sr // 2 + rng.randint(0, sr // 4)
    signal[start:start + len(voiced)] += voiced
    if zero_tail:
        signal[-1600:] = 0
    return signal.astype(np.int16), noise[:sr].astype(np.int16)


@pytest.mark.parametrize("case", ["given_noise", "tail_noise", "zero_tail", "order_3"])
def test_vad_decisions_and_spans_equal_jax(case):
    signal, noise = _speech_in_noise({"given_noise": 0, "tail_noise": 1, "zero_tail": 2,
                                      "order_3": 3}[case], zero_tail=case == "zero_tail")
    kw = {"order": 3, "noise_update_every": 5} if case == "order_3" else {}
    given = noise if case in ("given_noise", "order_3") else None
    got_d, got_s = LtsdVad(LtsdConfig(**kw)).detect(signal, noise=given)
    want_d, want_s = JaxLtsdVad(JaxLtsdConfig(**kw)).detect(signal, noise=given)
    np.testing.assert_array_equal(got_d, want_d)
    assert got_s == want_s and len(got_s) >= 1 and got_d.any() and not got_d.all()
    speech = LtsdVad(LtsdConfig(**kw)).extract_speech(signal, noise=given)
    np.testing.assert_array_equal(
        speech, JaxLtsdVad(JaxLtsdConfig(**kw)).extract_speech(signal, noise=given))
    assert speech.dtype == signal.dtype
    assert LtsdVad().extract_speech(np.zeros(100, np.int16)).shape == (0,)


def test_label_smoothing_and_spectrogram_image_equal_jax(tmp_path):
    rng = np.random.RandomState(4)
    x = rng.rand(3, 5, 11).astype(np.float32)
    for eps in (0.1, 0.25):
        got = misc.label_smoothing(torch.from_numpy(x), epsilon=eps).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_misc.label_smoothing(jnp.asarray(x), eps)),
                                   rtol=1e-7, atol=0)
    one_hot = misc.label_smoothing(torch.eye(4)[:1], 0.1)
    torch.testing.assert_close(one_hot, torch.tensor([[0.925, 0.025, 0.025, 0.025]]))
    image = pytest.importorskip("matplotlib.image")
    spec = rng.randn(50, 16)
    misc.save_spectrogram_image(torch.from_numpy(spec), str(tmp_path / "port.png"))
    jax_misc.save_spectrogram_image(spec, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(image.imread(str(tmp_path / "port.png")),
                                  image.imread(str(tmp_path / "jax.png")))


# ---------------------------------------------------------------------------
# data/prep.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Each importer's layout, with a few seeded utterances."""
    root = tmp_path_factory.mktemp("corpora")
    ai = root / "aishell"
    os.makedirs(ai / "transcript")
    os.makedirs(ai / "wav" / "train" / "S0001")
    os.makedirs(ai / "wav" / "train" / "S0002")
    lines = []
    for i in range(5):
        utt = f"BAC009S000{1 + i % 2}W{i:04d}"
        _wav(ai / "wav" / "train" / f"S000{1 + i % 2}" / f"{utt}.wav", n=3200 + 900 * i, seed=i)
        if i != 4:                                   # one wave has no transcript
            lines.append(f"{utt} {'你 好 世界 再见'[:2 * (i % 3) + 3]}\n")
    (ai / "transcript" / "aishell_transcript_v0.8.txt").write_text(
        "".join(lines) + "garbage\n", encoding="utf-8")
    th = root / "thchs30" / "train"
    os.makedirs(th)
    os.makedirs(root / "thchs30" / "data")
    _wav(th / "A1_0.wav", seed=5)
    (th / "A1_0.wav.trn").write_text("绿 是 阳春\nlv shi\n", encoding="utf-8")
    _wav(th / "A1_1.wav", seed=6)
    (th / "A1_1.wav.trn").write_text("../data/A1_1.wav.trn\n", encoding="utf-8")
    (root / "thchs30" / "data" / "A1_1.wav.trn").write_text("烟 雨 江南\n", encoding="utf-8")
    _wav(th / "A1_2.wav", seed=7)                     # no .trn: skipped
    st = root / "stcmds"
    os.makedirs(st)
    for i in range(2):
        _wav(st / f"20170001P00001A000{i}.wav", seed=8 + i)
        (st / f"20170001P00001A000{i}.txt").write_text("今天 天气"[:3 + i], encoding="utf-8")
    md = root / "magic" / "train" / "SPK1"
    os.makedirs(md)
    _wav(md / "u1.wav", seed=10)
    (root / "magic" / "train" / "TRANS.txt").write_text(
        "UtteranceID\tSpeakerID\tTranscription\nu1.wav\tSPK1\t你好 吗\nu2.wav\tSPK1\t缺\nbad\n",
        encoding="utf-8")
    pw = root / "prime" / "audio_files" / "0"
    os.makedirs(pw)
    _wav(pw / "x.wav", seed=11)
    (root / "prime" / "set1_transcript.json").write_text(
        json.dumps([{"file": "x.wav", "text": "早上 好"}, {"file": "y.wav", "text": "无"}]),
        encoding="utf-8")
    ad = root / "aida" / "corpus" / "train" / "G0001"
    os.makedirs(ad)
    _wav(ad / "T0001.wav", seed=12)
    (ad / "T0001.txt").write_text("晚上 好", encoding="utf-8")
    return root


@pytest.mark.parametrize("name,sub,split,n_rows", [
    ("aishell", "aishell", "train", 4), ("thchs30", "thchs30", "train", 2),
    ("aidatatang", "aida", "train", 1), ("primewords", "prime", None, 1),
    ("stcmds", "stcmds", None, 2), ("magicdata", "magic", "train", 1)])
def test_importers_equal_jax(corpora, name, sub, split, n_rows):
    args = (str(corpora / sub),) + ((split,) if split else ())
    got = prep.IMPORTERS[name](*args)
    assert got == jax_prep.IMPORTERS[name](*args)
    assert len(got) == n_rows and all(" " not in label for _, label in got)


def test_manifests_table_stats_clip_and_dump_equal_jax(corpora, tmp_path):
    rows = prep.import_aishell(str(corpora / "aishell"), "train") \
        + prep.import_thchs30(str(corpora / "thchs30"), "train")
    port, jax = tmp_path / "port", tmp_path / "jax"
    for d, mod in ((port, prep), (jax, jax_prep)):
        mod.write_manifest(rows, str(d / "train.csv"))
        mod.write_manifest(rows[:2], str(d / "dev.csv"))
        assert mod.merge_manifests([str(d / "train.csv"), str(d / "dev.csv")],
                                   str(d / "all.csv")) == len(rows) + 2
        mod.build_grapheme_table([str(d / "all.csv")], str(d / "vocab.txt"), min_count=1)
        mod.build_grapheme_table([str(d / "all.csv")], str(d / "vocab2.txt"), min_count=2)
        for check_audio in (False, True):
            assert mod.clip_by_length(str(d / "all.csv"), str(d / f"clip{check_audio}.csv"),
                                      max_label_len=4, max_audio_seconds=0.35,
                                      check_audio=check_audio) \
                == jax_prep.clip_by_length(str(d / "all.csv"), str(d / "want.csv"),
                                           max_label_len=4, max_audio_seconds=0.35,
                                           check_audio=check_audio)
        assert mod.dump_features(str(d / "train.csv"), str(d / "f.ark"), str(d / "f.scp"),
                                 feature_dim=8) == len(rows)
    for name in ("train.csv", "all.csv", "vocab.txt", "vocab2.txt", "clipFalse.csv",
                 "clipTrue.csv", "f.ark"):
        assert (port / name).read_bytes() == (jax / name).read_bytes(), name
    vocab = prep.build_grapheme_table([str(port / "all.csv")], str(tmp_path / "v.txt"))
    assert vocab.index2word[0] == "<b>" and vocab.index2word[len(vocab) - 1] == "<unk>"
    assert prep.target_length_stats(str(port / "all.csv")) \
        == jax_prep.target_length_stats(str(jax / "all.csv"))
    got = prep.audio_duration_stats(str(port / "all.csv"), coverage_step=1, coverage_start=1)
    want = jax_prep.audio_duration_stats(str(jax / "all.csv"), coverage_step=1,
                                         coverage_start=1)
    assert {k: v for k, v in got.items() if k != "max_file"} \
        == {k: v for k, v in want.items() if k != "max_file"}
    assert got["max_file"] == want["max_file"]
    mats = dict(kaldiio.read_mat_scp(str(port / "f.scp")))
    want_mats = dict(jax_kaldiio.read_mat_scp(str(jax / "f.scp")))
    assert list(mats) == list(want_mats)
    for key in mats:
        np.testing.assert_array_equal(mats[key], want_mats[key])
        assert mats[key].shape[1] == 8 * 4


def test_prep_cli(corpora, tmp_path, capsys):
    csv_path = str(tmp_path / "train.csv")
    prep.main(["import", "aishell", str(corpora / "aishell"), "--split", "train",
               "--out", csv_path])
    assert prep.read_manifest(csv_path) == jax_prep.import_aishell(str(corpora / "aishell"),
                                                                   "train")
    prep.main(["vocab", csv_path, "--out", str(tmp_path / "vocab.txt")])
    jax_prep.build_grapheme_table([csv_path], str(tmp_path / "want.txt"))
    assert (tmp_path / "vocab.txt").read_bytes() == (tmp_path / "want.txt").read_bytes()
    capsys.readouterr()
    prep.main(["stats", csv_path])
    assert json.loads(capsys.readouterr().out) == jax_prep.target_length_stats(csv_path)
    prep.main(["audio-stats", csv_path])
    stats = json.loads(capsys.readouterr().out)
    want = jax_prep.audio_duration_stats(csv_path)
    assert stats["histogram"] == {str(k): v for k, v in sorted(want["histogram"].items())}
    assert stats["coverage"] == want["coverage"] and stats["count"] == 4


# ---------------------------------------------------------------------------
# tools/average_checkpoints.py
# ---------------------------------------------------------------------------

def _native_model(state=None):
    model = build_transducer(Config(tiny_model_cfg()), device="cpu")
    if state is not None:
        model.load_state_dict(state)
    return model


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """The same three epochs as a JAX experiment (msgpack) and a port one,
    with metrics ranking epoch 1 first, then 0, then 2."""
    root = tmp_path_factory.mktemp("avg")
    cfg = Config(tiny_model_cfg())
    trees = [random_jax_params(cfg, seed=s) for s in range(3)]
    jax_exp, port_exp = str(root / "jax"), str(root / "port")
    for e, tree in enumerate(trees):
        jax_ckpt.save_checkpoint(os.path.join(jax_exp, f"epoch_{e}"), tree, epoch=e, step=10 * e)
        ckpt_lib.save_checkpoint(os.path.join(port_exp, f"epoch_{e}"),
                                 _native_model(from_jax_params(tree)), epoch=e, step=10 * e)
    for exp in (jax_exp, port_exp):
        with open(os.path.join(exp, "metrics.jsonl"), "w") as fh:
            for e, cer in [(0, 30.0), (1, 10.0), (2, 50.0), (2, 5.0), (2, 60.0)]:
                fh.write(json.dumps({"tag": "cer", "value": cer, "step": e}) + "\n")
                fh.write(json.dumps({"tag": "eval_loss", "value": 100 - cer, "step": e}) + "\n")
    return trees, jax_exp, port_exp


def _comps(path):
    state = ckpt_lib.load_checkpoint(path, "cpu")
    return {c: state[c] for c in ckpt_lib.COMPONENTS}


def _assert_same(got, want):
    assert {c: sorted(sd) for c, sd in got.items()} == {c: sorted(sd) for c, sd in want.items()}
    for c in got:
        for k in got[c]:
            assert got[c][k].dtype == want[c][k].dtype and torch.equal(got[c][k], want[c][k]), k


@pytest.mark.parametrize("nbest,criterion", [(2, "cer"), (1, "cer"), (2, "eval_loss")])
def test_average_checkpoints_equals_the_jax_tool(experiments, tmp_path, nbest, criterion):
    trees, jax_exp, port_exp = experiments
    args = ["--nbest", str(nbest), "--criterion", criterion]
    want_dir = _jax_tool("average_checkpoints").main([jax_exp, *args,
                                                      "--out", str(tmp_path / "jax")])
    want = _comps(want_dir)
    for exp in (port_exp, jax_exp):
        out = average_checkpoints.main([exp, *args, "--out", str(tmp_path / os.path.basename(exp)),
                                        "--device", "cpu"])
        _assert_same(_comps(out), want)
        with open(os.path.join(out, "meta.json")) as fh:
            meta = json.load(fh)
        with open(os.path.join(want_dir, "meta.json")) as fh:
            assert meta == json.load(fh)
    chosen = {(2, "cer"): [1, 0], (1, "cer"): [1], (2, "eval_loss"): [2, 0]}[(nbest, criterion)]
    assert meta["averaged_from"] == [f"epoch_{e}" for e in chosen]
    # each leaf: the float64 mean, rounded to float32
    sds = [from_jax_params(trees[e]) for e in chosen]
    flat = {f"{c}.{k}": v for c, sd in _comps(out).items() for k, v in sd.items()}
    for key, leaf in flat.items():
        mean = sum(sd[key].double() for sd in sds) / len(sds)
        assert torch.equal(leaf, mean.float()), key
    if nbest == 1:
        assert all(torch.equal(flat[k], sds[0][k]) for k in flat)
    # the average serves like any checkpoint
    model = load_family(Config({"model": tiny_model_cfg()}), tiny_model_cfg()["enc"]["d_model"],
                        out, device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(value, flat[key])


def test_average_integer_leaves_and_explicit_checkpoints_equal_the_jax_tool(tmp_path):
    """Integer leaves: summed in int64 and floor-divided (ESPnet's rule),
    as JAX's tool does on msgpack trees; ``--checkpoints`` skips the
    ranking; an int8-baked checkpoint is refused."""
    rng = np.random.RandomState(5)
    trees = [{c: {"w": rng.randn(3, 4).astype(np.float32),
                  "n": rng.randint(-9, 9, size=(5,)).astype(np.int64)}
              for c in ckpt_lib.COMPONENTS} for _ in range(3)]
    jax_dirs, port_dirs = [], []
    for i, tree in enumerate(trees):
        d = tmp_path / f"jax_{i}"
        os.makedirs(d)
        for c, leaves in tree.items():
            (d / f"{c}.msgpack").write_bytes(flax.serialization.msgpack_serialize(leaves))
        jax_dirs.append(str(d))
        d = tmp_path / f"port_{i}"
        os.makedirs(d)
        torch.save({**{c: {k: torch.from_numpy(v) for k, v in leaves.items()}
                       for c, leaves in tree.items()}, "optimizer": None, "epoch": i, "step": i},
                   d / ckpt_lib.MODEL_FILE)
        port_dirs.append(str(d))
    want_dir = _jax_tool("average_checkpoints").main(["--checkpoints", *jax_dirs,
                                                      "--out", str(tmp_path / "jax_avg")])
    out = average_checkpoints.main(["--checkpoints", *port_dirs, "--device", "cpu"])
    assert os.path.basename(out) == "ave_3ckpt" and os.path.dirname(out) == str(tmp_path)
    got = _comps(out)
    for c in ckpt_lib.COMPONENTS:
        with open(os.path.join(want_dir, f"{c}.msgpack"), "rb") as fh:
            want = flax.serialization.msgpack_restore(fh.read())
        for k in ("w", "n"):
            np.testing.assert_array_equal(got[c][k].numpy(), want[k])
            assert got[c][k].numpy().dtype == want[k].dtype
    assert (got["encoder"]["n"].numpy()
            == np.floor_divide(sum(t["encoder"]["n"] for t in trees), 3)).all()
    quant = tmp_path / "port_q"
    os.makedirs(quant)
    torch.save({"encoder": {}, "decoder": {}, "joint": {}, "optimizer": None, "quant": "int8"},
               quant / ckpt_lib.MODEL_FILE)
    with pytest.raises(ValueError, match="int8-baked"):
        average_checkpoints.main(["--checkpoints", port_dirs[0], str(quant), "--device", "cpu"])


# ---------------------------------------------------------------------------
# tools/convert_checkpoint.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["native", "espnet"])
def test_convert_checkpoint_equals_the_jax_tool(tmp_path, family):
    torch.manual_seed(3)
    if family == "native":
        cfg = Config({"model": tiny_model_cfg()})
        model = build_transducer(cfg.model, device="cpu")
        d_in = tiny_model_cfg()["enc"]["d_model"]
    else:
        cfg = Config({"model": tiny_espnet_cfg()})
        model = build_espnet_transducer(cfg.model, device="cpu")
        d_in = tiny_espnet_cfg()["enc"]["input_size"]
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01 * torch.randn_like(p))          # no zero bias hides a key
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    chkpt = str(tmp_path / "epoch7.chkpt")
    encoder = dict(model.encoder.state_dict(), **{"pos_emb.inv_freq": torch.ones(4)})
    torch.save({"encoder": encoder, "decoder": model.decoder.state_dict(),
                "joint": model.joint.state_dict(), "optimizer": opt.state_dict(),
                "epoch": 7, "step": 1234}, chkpt)
    flag = ["--espnet"] if family == "espnet" else []
    _jax_tool("convert_checkpoint").main([chkpt, str(tmp_path / "jax"), *flag])
    out = convert_checkpoint.main([chkpt, str(tmp_path / "port"), *flag, "--device", "cpu"])
    got, want = _comps(out), _comps(str(tmp_path / "jax"))
    _assert_same(got, want)
    with open(os.path.join(out, "meta.json")) as fh:
        assert json.load(fh) == {"epoch": 7, "step": 1234}
    assert ckpt_lib.load_checkpoint(out)["optimizer"] is None
    served = load_family(cfg, d_in, out, device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(served.state_dict()[key], value), key
    broken = {"encoder": {k: v for k, v in encoder.items() if "norm" not in k},
              "decoder": model.decoder.state_dict(), "joint": model.joint.state_dict()}
    with pytest.raises(KeyError, match="the encoder lacks"):
        convert_checkpoint.convert(broken, family == "espnet")


# ---------------------------------------------------------------------------
# the plot tools and the tone demo's learning run
# ---------------------------------------------------------------------------

def test_plot_tools(tmp_path, capsys, monkeypatch):
    pytest.importorskip("matplotlib")
    exp = tmp_path / "exp"
    os.makedirs(exp)
    with open(exp / "metrics.jsonl", "w") as fh:
        for step, (loss, cer) in enumerate([(3.0, 90.0), (2.0, 50.0), (1.5, 40.0)]):
            fh.write(json.dumps({"tag": "train_loss", "value": loss, "step": step}) + "\n")
            fh.write(json.dumps({"tag": "cer", "value": cer, "step": step}) + "\n")
    assert plot_training.load_metrics(str(exp)) == _jax_tool("plot_training").load_metrics(str(exp))
    capsys.readouterr()
    out = plot_training.main([str(exp)])
    port_text = capsys.readouterr().out
    assert os.path.getsize(out) > 1000 and out == str(exp / "curves.png")
    monkeypatch.setattr(sys, "argv", ["plot_training.py", str(exp), "--print"])
    _jax_tool("plot_training").main()
    assert port_text.splitlines()[:-1] == capsys.readouterr().out.splitlines()
    wav = _wav(tmp_path / "u.wav", n=8000, seed=3)
    for kw in ({}, {"stack": 3, "subsample": 3}):
        np.testing.assert_array_equal(plot_features.load_features(wav, 32, **kw),
                                      _jax_tool("plot_features").load_features(wav, 32, **kw))
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    kaldiio.write_ark_scp(ark, scp, {"u": jax_F.logmel_masked(np.zeros(800, np.int16), 16000, 8)})
    (line,) = open(scp).read().splitlines()
    np.testing.assert_array_equal(plot_features.load_features(line.split()[1]),
                                  kaldiio.read_mat(line.split()[1]))
    png = plot_features.main([wav, "--feature-dim", "32", "--stack", "3",
                              "--out", str(tmp_path / "u.png")])
    assert os.path.getsize(png) > 1000


def test_tone_demo_runs_one_epoch_on_the_cpu(tmp_path, capfd):
    out = str(tmp_path / "demo")
    summary = tone_demo.main(["--out", out, "--epochs", "1", "--geometry", "small",
                              "--n-train", "16", "--n-dev", "4", "--device", "cpu"])
    last = capfd.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"final_dev_cer": summary["final_dev_cer"],
                                "best_dev_cer": summary["best_dev_cer"]}
    with open(os.path.join(out, "summary.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(summary))
    assert set(summary) == {"geometry", "corpus", "flags", "first_train_loss",
                            "last_train_loss", "dev_cer_curve", "final_dev_cer", "best_dev_cer"}
    assert summary["flags"] == "--bf16 --nan-guard --steps-per-call 8"
    assert len(summary["dev_cer_curve"]) == 1 and np.isfinite(summary["first_train_loss"])
    for name in ("metrics.jsonl", "train.log", "config.yaml"):
        assert os.path.exists(os.path.join(out, name))
    assert "bfloat16" in open(os.path.join(out, "train.log")).read()
    assert not os.path.exists(os.path.join(out, "corpus", "wav"))
    assert os.path.exists(os.path.join(out, "corpus", "train.csv"))
