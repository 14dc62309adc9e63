"""Time the banded rel-position attention backward (``ttx_banded_attention_bwd``)
or, with ``--pass fwd``, its forward (``ttx_banded_attention_fwd``) alone, as
``chip_smoke.py`` times them: 20 calls of the wrapper in one CUDA graph, the
median of 10 replays, per call.  The forward runs as recognition runs it,
under ``torch.no_grad()`` (no row log-sum-exp).  With ``--pass logz`` it
times the pruned loss's additive logZ (``ttx_additive_logz``, every launch
of a call) the same way; a shape is then B,T,U1,V and the logits are
randn * 3, as ``chip_smoke.py`` draws them.  With ``--pass alpha`` or
``--pass beta`` it times the pruned loss's band alpha or beta sweep
(``ttx_band_alpha``, ``ttx_band_beta``, both launches of a call); a shape
is then B,T,S and the inputs are drawn as ``chip_smoke.py::band_inputs``
draws them (the first sequence T frames long), and ``--chunks N ...`` also
times the kernel at those of the chunk counts that the plan may pick (at
most ``MAX_STARTS`` start vectors), beside the plan's.  With ``--pass
lattice_alpha`` or ``--pass lattice_beta`` it times an RNN-T lattice sweep
(``ttx_rnnt_alpha``, ``ttx_rnnt_beta``); a shape is then B,T,U (U1 = U + 1)
and the inputs are ``chip_smoke.py::lattice_inputs``'s, the first sequence
full length.  With ``--pass bf16_fwd`` it times the flash forward's bf16
form (``ttx_flash_rel_attention_fwd_bf16``) without the lse, as served, and
with the lse and sums, as trained; a shape is then B,T,H,Dh and q, k, v
are strided views of one bf16 projection, as ``chip_smoke.py`` draws them.
With ``--pass bf16_bwd`` it times the flash backward's bf16 form
(``flash_backward_bf16``, the wrapper as training calls it) on the same
inputs, the forward's lse and sums and a float32 output gradient.
With several checkouts a lattice sweep or a bf16 flash pass also saves its
outputs (the backward's six gradients), and the largest |difference| of
every checkout's from the first's is printed after them.  Each checkout given
runs in its own process (the packages share a name), builds its own kernels
into its own ``build/`` and is timed at every shape; the checkouts run in
the order given, so ``--roots old new new old`` compares two versions on
one card in one run.

    python3 transformer_transducer_tpu_torch/tools/time_banded_bwd.py \\
        --roots build/parent . . build/parent [--pass fwd] \\
        --shapes 4,410,8,64 4,410,8,32 4,48,2,32 --band 10 2

A shape is B,T,H,Dh (inputs fp32, drawn from a seed; bf16 for
``--pass bf16_fwd`` and ``bf16_bwd``), B,T,U1,V for
``--pass logz``, B,T,S for ``--pass alpha`` and ``--pass beta`` or B,T,U
for the lattice passes.  Prints one line a checkout and shape, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


LATTICE = ("lattice_alpha", "lattice_beta")
SAVED = LATTICE + ("bf16_fwd", "bf16_bwd")     # passes whose outputs are compared


def time_one(root: str, shapes, band, which: str, chunks=(), save=None) -> None:
    """Time the ``which`` pass ("fwd", "bwd", "logz", "alpha", "beta", a
    lattice sweep, "bf16_fwd" or "bf16_bwd") of the package under ``root``
    at each shape; a lattice sweep's or a bf16 flash pass's outputs go to
    ``save``, if given."""
    sys.path.insert(0, REPO)
    import torch
    from chip_smoke import band_inputs, graph_ms, lattice_inputs   # this checkout's
    sys.path.insert(0, os.path.abspath(root))
    from transformer_transducer_tpu_torch.ops.cuda import common
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_backward)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if which in LATTICE:
        from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
            alpha_scan, beta_scan)
        outputs = {}
        for b, t, u in shapes:
            sb, sl, inject = lattice_inputs(b, t, u, gen, with_empty=False)
            run = ((lambda: alpha_scan(sb, sl)) if which == "lattice_alpha"
                   else (lambda: beta_scan(sb, sl, inject)))
            outputs[f"{b},{t},{u}"] = run().cpu()
            print(json.dumps({"root": root, "pass": which, "B": b, "T": t, "U1": u + 1,
                              "ms": graph_ms(run)}), flush=True)
        if save:
            torch.save(outputs, save)
        return
    if which in ("bf16_fwd", "bf16_bwd"):
        from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
        outputs = {}
        for b, t, h, dh in shapes:
            mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = mk(b, t, 3, h, dh).unbind(2)
            args = (q, k, v, mk(t, h, dh), mk(h, dh), mk(t, h))
            key = f"{b},{t},{h},{dh}"
            rec = {"root": root, "pass": which, "B": b, "T": t, "H": h, "Dh": dh}
            with torch.no_grad():
                if which == "bf16_fwd":
                    rec["ms"] = graph_ms(lambda: fa.flash_forward_bf16(*args, with_lse=False))
                    rec["ms_with_lse"] = graph_ms(
                        lambda: fa.flash_forward_bf16(*args, with_lse=True))
                    outputs[key] = torch.stack(
                        [x.cpu() for x in fa.flash_forward_bf16(*args, with_lse=True)[::2]])
                else:
                    _, lse, sums = fa.flash_forward_bf16(*args, with_lse=True)
                    gout = torch.randn(b, t, h, dh, generator=gen, device="cuda")
                    run = lambda: fa.flash_backward_bf16(*args, sums, lse, gout)
                    rec["ms"] = graph_ms(run)
                    for name, x in zip(("dq", "dk", "dv", "dre", "du", "drb"), run()):
                        outputs[f"{key} {name}"] = x.float().cpu()
            print(json.dumps(rec), flush=True)
        if save:
            torch.save(outputs, save)
        return
    if which == "logz":
        from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import additive_logz
        for b, t, u1, v in shapes:
            a = torch.randn(b, t, v, generator=gen, device="cuda") * 3
            l = torch.randn(b, u1, v, generator=gen, device="cuda") * 3
            with torch.no_grad():
                ms = graph_ms(lambda: additive_logz(a, l))
            print(json.dumps({"root": root, "pass": which, "B": b, "T": t, "U1": u1,
                              "V": v, "ms": ms}), flush=True)
        return
    if which in ("alpha", "beta"):
        from transformer_transducer_tpu_torch.ops.cuda import band_kernel as bk
        for b, t, s_range in shapes:
            lp_b, lp_l, d_a, d_b, tf, sf = band_inputs(gen, b, t, s_range)
            if which == "alpha":
                run = lambda n=None: bk._launch_alpha(lp_b, lp_l, d_a, n)
                wrapper = lambda: bk.band_alpha(lp_b, lp_l, d_a, s_range)
            else:
                run = lambda n=None: bk._launch_beta(lp_b, lp_l, d_b, tf, sf, n)
                wrapper = lambda: bk.band_beta(lp_b, lp_l, d_b, tf, sf, s_range)
            rec = {"root": root, "pass": which, "B": b, "T": t, "S": s_range,
                   "ms": graph_ms(wrapper)}
            if chunks:      # the chunk counts forced, and the plan's
                rec["plan"] = bk.band_alpha_plan(t, s_range)
                rec["ms_by_chunks"] = {
                    n: graph_ms(lambda: run(n))
                    for n in sorted({n for n in chunks if n <= t and n * s_range <= bk.MAX_STARTS}
                                    | {rec["plan"]})}
            print(json.dumps(rec), flush=True)
        return
    for b, t, h, dh in shapes:
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        args = (mk(b, t, h, dh), mk(b, t, h, dh), mk(b, t, h, dh), mk(t, h, dh),
                mk(h, dh), mk(t, h))
        if which == "fwd":
            with torch.no_grad():
                ms = graph_ms(lambda: banded_attention(*args, *band))
        else:
            out, lse, _ = common.launch_forward("ttx_banded_attention_fwd", args, band,
                                                with_lse=True)
            gout = mk(b, t, h, dh)
            ms = graph_ms(lambda: banded_attention_backward(*args, out, lse, gout, *band))
        print(json.dumps({"root": root, "pass": which, "B": b, "T": t, "H": h,
                          "Dh": dh, "band": list(band), "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts whose port package is timed, in this order")
    ap.add_argument("--pass", dest="which",
                    choices=("fwd", "bwd", "logz", "alpha", "beta") + SAVED,
                    default="bwd",
                    help="the wrapper timed: the banded forward or backward, the logZ, "
                    "a band sweep, a lattice sweep or a bf16 form of the flash kernels")
    ap.add_argument("--shapes", nargs="+", default=["4,410,8,64"],
                    help="B,T,H,Dh (B,T,U1,V for logz, B,T,S for alpha and beta, B,T,U "
                    "for the lattice sweeps)")
    ap.add_argument("--band", nargs=2, type=int, default=[10, 2], metavar=("LEFT", "RIGHT"))
    ap.add_argument("--chunks", nargs="*", type=int, default=[],
                    help="with --pass alpha or beta, also time these chunk counts and "
                    "the plan's (a checkout whose band_kernel has that chunked kernel)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    a = ap.parse_args()
    shapes = [tuple(int(x) for x in s.split(",")) for s in a.shapes]
    if a.one:
        time_one(a.one, shapes, tuple(a.band), a.which, a.chunks, a.save)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        saved = []
        for i, root in enumerate(a.roots):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root, "--pass",
                   a.which, "--shapes", *a.shapes, "--band", *map(str, a.band),
                   "--chunks", *map(str, a.chunks)]
            if a.which in SAVED and len(a.roots) > 1:
                saved.append(os.path.join(tmp, f"{i}.pt"))
                cmd += ["--save", saved[-1]]
            if subprocess.run(cmd).returncode != 0:
                return 1
        if saved:       # every checkout's outputs against the first's
            first = torch.load(saved[0])
            for root, path in zip(a.roots[1:], saved[1:]):
                out = torch.load(path)
                print(json.dumps({"root": root, "against": a.roots[0], "pass": a.which,
                                  "max_abs_diff": {k: (out[k] - first[k]).abs().max().item()
                                                   for k in first}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
