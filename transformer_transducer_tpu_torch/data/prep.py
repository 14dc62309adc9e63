"""Corpus preparation: importers, manifests, the grapheme table, statistics,
clipping and the offline feature dump (port of ``data/prep.py``).

The reference's offline prep (``data/data_process.py``) has a manifest
generator for each corpus: AISHELL-1 (:244), THCHS30 (:282), aidatatang
(:301), primewords (:331), ST-CMDS (:358) and magicdata (:384); corpus
merging and the grapheme table with blank ``<b>`` at 0 (:417-549); the
train/dev/test CSVs (``file_path,label``, :738-783); label and audio length
statistics and clipping (:552-699); and the offline feature dump (:701-736,
a kaldi ark/scp here).  Everything runs once, offline, on the host; the
dataset reads only the CSVs and the grapheme table.

    python -m transformer_transducer_tpu_torch.data.prep import aishell ROOT \
        --split train --out train.csv
    python -m transformer_transducer_tpu_torch.data.prep vocab train.csv --out vocab.txt
    python -m transformer_transducer_tpu_torch.data.prep {merge,stats,audio-stats,clip,
        dump-features} ...
"""

from __future__ import annotations

import csv
import glob
import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from transformer_transducer_tpu_torch.data import kaldiio
from transformer_transducer_tpu_torch.data.dataset import read_manifest
from transformer_transducer_tpu_torch.data.wav import read_wave
from transformer_transducer_tpu_torch.ops import features_np as F
from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

Row = Tuple[str, str]  # (wav_path, transcript)


def _clean_text(text: str) -> str:
    """Strip whitespace inside transcripts (Mandarin corpora space-separate
    words/chars inconsistently; the reference removes spaces when building
    character labels, ``data/data_process.py:493-549``)."""
    return "".join(text.split())


# ---------------------------------------------------------------------------
# Corpus importers -> list of (wav_path, transcript)
# ---------------------------------------------------------------------------

def import_aishell(root: str, split: str) -> List[Row]:
    """AISHELL-1: wav/<split>/SXXXX/*.wav + transcript/aishell_transcript_v0.8.txt."""
    trans_path = os.path.join(root, "transcript", "aishell_transcript_v0.8.txt")
    transcripts = {}
    with open(trans_path, "r", encoding="utf-8") as fh:
        for line in fh:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                transcripts[parts[0]] = _clean_text(parts[1])
    rows = []
    for wav in sorted(glob.glob(os.path.join(root, "wav", split, "*", "*.wav"))):
        utt = os.path.splitext(os.path.basename(wav))[0]
        if utt in transcripts:
            rows.append((wav, transcripts[utt]))
    return rows


def import_thchs30(root: str, split: str) -> List[Row]:
    """THCHS30: <split>/*.wav with sibling ``*.wav.trn`` (first line = text)."""
    rows = []
    for wav in sorted(glob.glob(os.path.join(root, split, "*.wav"))):
        trn = wav + ".trn"
        if not os.path.exists(trn):
            continue
        with open(trn, "r", encoding="utf-8") as fh:
            first = fh.readline().strip()
        if first.endswith(".trn"):  # pointer file into data/ dir
            with open(os.path.join(os.path.dirname(wav), first), "r",
                      encoding="utf-8") as fh:
                first = fh.readline().strip()
        rows.append((wav, _clean_text(first)))
    return rows


def import_aidatatang(root: str, split: str) -> List[Row]:
    """aidatatang_200zh: corpus/<split>/**/*.wav + sibling .txt transcripts."""
    rows = []
    for wav in sorted(glob.glob(os.path.join(root, "corpus", split, "**",
                                             "*.wav"), recursive=True)):
        txt = os.path.splitext(wav)[0] + ".txt"
        if os.path.exists(txt):
            with open(txt, "r", encoding="utf-8") as fh:
                rows.append((wav, _clean_text(fh.read())))
    return rows


def import_primewords(root: str) -> List[Row]:
    """primewords_md_2018: set1_transcript.json [{file, text, ...}] +
    audio_files/**/<file>."""
    with open(os.path.join(root, "set1_transcript.json"), "r",
              encoding="utf-8") as fh:
        entries = json.load(fh)
    by_name = {}
    for wav in glob.glob(os.path.join(root, "audio_files", "**", "*.wav"),
                         recursive=True):
        by_name[os.path.basename(wav)] = wav
    rows = []
    for e in entries:
        wav = by_name.get(e["file"])
        if wav:
            rows.append((wav, _clean_text(e["text"])))
    return rows


def import_stcmds(root: str) -> List[Row]:
    """ST-CMDS: flat dir of ``*.wav`` + ``*.txt`` pairs."""
    rows = []
    for wav in sorted(glob.glob(os.path.join(root, "*.wav"))):
        txt = os.path.splitext(wav)[0] + ".txt"
        if os.path.exists(txt):
            with open(txt, "r", encoding="utf-8") as fh:
                rows.append((wav, _clean_text(fh.read())))
    return rows


def import_magicdata(root: str, split: str) -> List[Row]:
    """magicdata: <split>/TRANS.txt (utt\\tspeaker\\ttext) + <split>/<spk>/<utt>."""
    trans = os.path.join(root, split, "TRANS.txt")
    rows = []
    with open(trans, "r", encoding="utf-8") as fh:
        header = fh.readline()
        del header
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            utt, spk, text = parts[0], parts[1], parts[2]
            wav = os.path.join(root, split, spk, utt)
            if os.path.exists(wav):
                rows.append((wav, _clean_text(text)))
    return rows


IMPORTERS = {
    "aishell": import_aishell,
    "thchs30": import_thchs30,
    "aidatatang": import_aidatatang,
    "primewords": lambda root, split=None: import_primewords(root),
    "stcmds": lambda root, split=None: import_stcmds(root),
    "magicdata": import_magicdata,
}


# ---------------------------------------------------------------------------
# Manifests, vocabulary, statistics
# ---------------------------------------------------------------------------

def write_manifest(rows: Sequence[Row], csv_path: str) -> None:
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    with open(csv_path, "w", newline="", encoding="utf-8") as fh:
        w = csv.writer(fh)
        w.writerow(["file_path", "label"])
        w.writerows(rows)


def merge_manifests(csv_paths: Sequence[str], out_path: str) -> int:
    """Concatenate manifests into a joint corpus CSV (reference ``merge``/
    ``merge_csv``, ``data/data_process.py:417,738``)."""
    rows: List[Row] = []
    for p in csv_paths:
        rows.extend(read_manifest(p))
    write_manifest(rows, out_path)
    return len(rows)


def build_grapheme_table(manifests: Sequence[str], out_path: str,
                         min_count: int = 1, add_unk: bool = True) -> Vocabulary:
    """Character inventory -> grapheme table with ``<b>`` blank at index 0
    (reference ``remove_token_and_generate_table``, :493-549)."""
    counts: Counter = Counter()
    for p in manifests:
        for _, label in read_manifest(p):
            counts.update(label)
    symbols = [s for s, c in sorted(counts.items()) if c >= min_count]
    if add_unk and "<unk>" not in symbols:
        symbols.append("<unk>")
    vocab = Vocabulary.from_symbols(symbols)      # the blank <b> at 0
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    vocab.save(out_path)
    return vocab


def target_length_stats(manifest: str) -> Dict[str, float]:
    """Label-length histogramming (reference ``targets_info``, :552-583)."""
    lens = [len(label) for _, label in read_manifest(manifest)]
    arr = np.asarray(lens)
    return {"count": len(arr), "min": int(arr.min()), "max": int(arr.max()),
            "mean": float(arr.mean()), "p95": float(np.percentile(arr, 95)),
            "p99": float(np.percentile(arr, 99))}


def audio_duration_stats(manifest: str, subsample: int = 3,
                         hop: int = 160,
                         coverage_step: int = 50,
                         coverage_start: int = 100) -> Dict[str, object]:
    """Utterance-duration statistics over a manifest (reference
    ``audio_info``, ``data/data_process.py:600-651``): per-utterance
    subsampled frame counts ``ceil(ceil(samples/hop)/subsample)``, their
    histogram, max/mean, and the cumulative coverage table the reference
    prints ("N utterances fit within L frames") at ``coverage_step``-frame
    limits.  Pure host-side stats; feeds ``max_input_length`` choices."""
    frames: List[int] = []
    max_frames, max_file = 0, ""
    for path, _ in read_manifest(manifest):
        wave, _rate = read_wave(path)
        n = -(-(-(-len(wave) // hop)) // subsample)  # ceil(ceil(s/hop)/sub)
        frames.append(n)
        if n > max_frames:
            max_frames, max_file = n, path
    arr = np.asarray(frames)
    hist: Dict[int, int] = {}
    for n in frames:
        hist[n] = hist.get(n, 0) + 1
    coverage = []
    # round the top limit UP to the next step so the final bucket (the one
    # holding max_frames, where coverage reaches 100%) is always printed
    top = max(max_frames, coverage_start)
    top = coverage_start + -(-(top - coverage_start) // coverage_step) \
        * coverage_step
    for limit in range(coverage_start, top + 1, coverage_step):
        valid = int((arr <= limit).sum())
        coverage.append({"limit": limit, "count": valid,
                         "pct": round(100.0 * valid / max(len(arr), 1), 2)})
    return {"count": len(arr), "max_frames": max_frames,
            "max_file": max_file, "mean_frames": float(arr.mean()),
            "seconds_per_frame": hop * subsample / 16000.0,
            "histogram": hist, "coverage": coverage}


def clip_by_length(manifest: str, out_path: str, max_label_len: int = 42,
                   max_audio_seconds: float = 12.3,
                   check_audio: bool = False) -> Tuple[int, int]:
    """Drop rows over the length caps (reference ``clip_targets``/
    ``audio_clip``, :585-699).  Returns (kept, dropped)."""
    kept, dropped = [], 0
    for path, label in read_manifest(manifest):
        ok = len(label) <= max_label_len
        if ok and check_audio:
            wave, rate = read_wave(path)
            ok = len(wave) / rate <= max_audio_seconds
        if ok:
            kept.append((path, label))
        else:
            dropped += 1
    write_manifest(kept, out_path)
    return len(kept), dropped


def dump_features(manifest: str, ark_path: str, scp_path: str,
                  feature_dim: int = 128, left: int = 3, right: int = 0,
                  subsample: int = 3) -> int:
    """Offline feature dump to kaldi ark/scp (reference ``joint_feature``/
    ``fbank_feature``, :701-736 — theirs writes .npy per utt; ark keeps one
    file)."""
    mats = {}
    for path, _ in read_manifest(manifest):
        wave, rate = read_wave(path)
        feats = F.subsample(F.stack_frames(
            F.logmel_eps(wave, rate, feature_dim), left, right), subsample)
        mats[os.path.splitext(os.path.basename(path))[0]] = feats
    kaldiio.write_ark_scp(ark_path, scp_path, mats)
    return len(mats)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="corpus preparation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("import", help="corpus -> manifest CSV")
    p.add_argument("corpus", choices=sorted(IMPORTERS))
    p.add_argument("root")
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True)

    p = sub.add_parser("merge")
    p.add_argument("csvs", nargs="+")
    p.add_argument("--out", required=True)

    p = sub.add_parser("vocab")
    p.add_argument("csvs", nargs="+")
    p.add_argument("--out", required=True)
    p.add_argument("--min-count", type=int, default=1)

    p = sub.add_parser("stats")
    p.add_argument("csv")

    p = sub.add_parser("audio-stats",
                       help="utterance frame-count histogram + coverage")
    p.add_argument("csv")
    p.add_argument("--subsample", type=int, default=3)

    p = sub.add_parser("clip")
    p.add_argument("csv")
    p.add_argument("--out", required=True)
    p.add_argument("--max-label-len", type=int, default=42)
    p.add_argument("--max-audio-seconds", type=float, default=12.3)
    p.add_argument("--check-audio", action="store_true")

    p = sub.add_parser("dump-features")
    p.add_argument("csv")
    p.add_argument("--ark", required=True)
    p.add_argument("--scp", required=True)

    args = ap.parse_args(argv)
    if args.cmd == "import":
        fn = IMPORTERS[args.corpus]
        rows = fn(args.root, args.split) if args.corpus not in (
            "primewords", "stcmds") else fn(args.root)
        write_manifest(rows, args.out)
        print(f"{len(rows)} utterances -> {args.out}")
    elif args.cmd == "merge":
        n = merge_manifests(args.csvs, args.out)
        print(f"{n} utterances -> {args.out}")
    elif args.cmd == "vocab":
        vocab = build_grapheme_table(args.csvs, args.out, args.min_count)
        print(f"{len(vocab)} units -> {args.out}")
    elif args.cmd == "stats":
        print(json.dumps(target_length_stats(args.csv), indent=2))
    elif args.cmd == "audio-stats":
        stats = audio_duration_stats(args.csv, subsample=args.subsample)
        stats["histogram"] = {str(k): v
                              for k, v in sorted(stats["histogram"].items())}
        print(json.dumps(stats, indent=2))
    elif args.cmd == "clip":
        kept, dropped = clip_by_length(args.csv, args.out,
                                       args.max_label_len,
                                       args.max_audio_seconds,
                                       args.check_audio)
        print(f"kept {kept}, dropped {dropped} -> {args.out}")
    elif args.cmd == "dump-features":
        n = dump_features(args.csv, args.ark, args.scp)
        print(f"{n} utterances -> {args.ark}")


if __name__ == "__main__":
    main()
