"""Time builds of the flash backward's bf16 form side by side on one card.

Each build is a copy of ``csrc/flash_rel_attention_bwd.cu`` (or of another
source given as ``NAME=PATH``) with parts of the work removed by the named
ablations below, compiled into its own library in ``build/variants/``.
The builds run in turns, twice: each time the three kernels of a call
(pre-pass, main kernel, casts), the main kernel alone, the pre-pass alone
and the casts alone, each under a CUDA graph (``chip_smoke.graph_ms``), on
bf16 inputs drawn as ``chip_smoke.py`` draws them and the bf16 forward's
lse and sums; and the largest |difference| of each build's six gradients
from the first build's.  An ablation's gradients are wrong by design.

    python3 transformer_transducer_tpu_torch/tools/time_bwd_bf16_builds.py \\
        base nodq+noemit nodre [old=path/to/other.cu] --shapes 4,410,8,64

A build is ``name`` (``base``, or ablations joined by ``+``) or
``NAME=PATH``.  Prints one JSON line a build, shape and turn, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(REPO, "transformer_transducer_tpu_torch", "csrc",
                   "flash_rel_attention_bwd.cu")

# name: (what it removes, [(text, replacement), ...])
ABLATIONS = {
    "nocopy": ("the cp.async copies", [
        ("namespace bbw {\n", "namespace bbw {\n#define cp16(d, s, ok) ((void)0)\n")]),
    "nodq": ("dq's reductions", [
        ("        emit_rows(acc, mq, nd, [&](int r) -> float* {",
         "        if (0) emit_rows(acc, mq, nd, [&](int r) -> float* {"),
        ("        if ((warp & 1) && lane < DH / 8 && i0 + TQ < T)", "        if (0)")]),
    "noemit": ("the tables' emission", [
        ("        emit_piece(st + 1 - NPW);", "        if (0) emit_piece(st + 1 - NPW);"),
        ("        if (st + 1 == nsteps)\n            for (int m",
         "        if (0)\n            for (int m")]),
    "nodre": ("d re's and d rb's products and ring", [
        ("            for (int im = 0; im < NXT / MSTRIDE; ++im) {",
         "            for (int im = 0; im < 0; ++im) {")]),
    "nodqbd": ("dq's BD products", [
        ("            for (int xk = 0; xk < NXT; ++xk) {\n                unsigned a4[4], m[2];",
         "            for (int xk = 0; xk < 0; ++xk) {\n                unsigned a4[4], m[2];")]),
    "noqe": ("QE's products", [
        ("            for (int ks = 0; ks < NKS; ++ks) {\n                unsigned qo[4], qn[4], bb[6][2];",
         "            for (int ks = 0; ks < 0; ++ks) {\n                unsigned qo[4], qn[4], bb[6][2];")]),
    "fastexp": ("expf (for __expf)", [("p[e] = live ? expf(", "p[e] = live ? __expf(")]),
}


def source_of(build: str) -> str:
    """The source text of a build."""
    if "=" in build:
        return open(build.split("=", 1)[1]).read()
    text = open(SRC).read()
    for name in build.split("+"):
        if name == "base":
            continue
        for old, new in ABLATIONS[name][1]:
            if text.count(old) < 1:
                raise ValueError(f"ablation {name}: its text is not in the source")
            text = text.replace(old, new)
    return text


def compile_all(builds, out_dir):
    """One nvcc a build, all at once; returns each library's path."""
    from transformer_transducer_tpu_torch.ops.cuda import build as B
    paths, procs = {}, {}
    for i, b in enumerate(builds):
        cu = os.path.join(out_dir, f"b{i}.cu")
        open(cu, "w").write(source_of(b))
        paths[b] = os.path.join(out_dir, f"b{i}.so")
        procs[b] = subprocess.Popen(
            [B._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
             "-I", os.path.dirname(SRC), "-o", paths[b], cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for b, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{b}: nvcc failed\n{err[-3000:]}")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and "flash_bwd_bf16ILi64" in line:
                print(json.dumps({"build": b, "ptxas": " | ".join(
                    x.strip() for x in lines[i + 1:i + 3])}), flush=True)
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", help="base, ablations joined by +, or NAME=PATH; "
                    "ablations: " + ", ".join(f"{k} ({v[0]})" for k, v in ABLATIONS.items()))
    ap.add_argument("--shapes", nargs="+", default=["4,410,8,64"], help="B,T,H,Dh")
    a = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import graph_ms, nvidia_smi
    from transformer_transducer_tpu_torch.ops.cuda import common
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    out_dir = os.path.join(REPO, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    paths = compile_all(a.builds, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for shape in a.shapes:
        b, t, h, dh = (int(x) for x in shape.split(","))
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = mk(b, t, 3, h, dh).unbind(2)
        args = (q, k, v, mk(t, h, dh), mk(h, dh), mk(t, h))
        with torch.no_grad():
            _, lse, sums = fa.flash_forward_bf16(*args, with_lse=True)
        cases.append(((b, t, h, dh), args, lse, sums,
                      torch.randn(b, t, h, dh, generator=gen, device="cuda")))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    first = {}
    for turn in range(2):
        for build in a.builds:
            lib = ctypes.CDLL(paths[build])
            fn = lib.ttx_flash_rel_attention_bwd_bf16_stages
            fn.argtypes = [i32] + [ptr] * 3 + [i64] * 3 + [ptr] * 13 + [i32] * 4 + [ptr]
            fn.restype = i32
            size = lib.ttx_flash_rel_attention_bwd_bf16_workspace
            size.argtypes, size.restype = [i32] * 4, i64
            for (b, t, h, dh), args, lse, sums, gout in cases:
                ptrs = common.kernel_args(*args)
                outs = [torch.empty_like(x, dtype=torch.bfloat16)
                        for x in (sums, sums, sums, *args[3:])]
                work = torch.empty(size(b, t, h, dh), device="cuda")

                def run(stages):
                    code = fn(stages, *ptrs, sums.data_ptr(), lse.data_ptr(), gout.data_ptr(),
                              *(o.data_ptr() for o in outs), work.data_ptr(), b, t, h, dh,
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"{build}: CUDA error {code}")

                run(7)
                torch.cuda.synchronize()
                got = [o.float() for o in outs]
                ref = first.setdefault((b, t, h, dh), got)
                print(json.dumps({
                    "build": build, "turn": turn, "B": b, "T": t, "H": h, "Dh": dh,
                    "ms_kernels": graph_ms(lambda: run(7)), "ms_main": graph_ms(lambda: run(2)),
                    "ms_prepass": graph_ms(lambda: run(1)), "ms_casts": graph_ms(lambda: run(4)),
                    "max_abs_diff": [(x - y).abs().max().item() for x, y in zip(got, ref)]}),
                    flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
