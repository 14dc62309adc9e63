"""How far the pruned loss's gradients on the card lie from the CPU's, and
from which band sweep's rounding.

    python3 -m transformer_transducer_tpu_torch.tools.grad_rounding

Runs ``rnnt_loss_pruned`` at the shapes and seed of
``tests/test_torch_port_cuda.py::test_pruned_loss_on_the_card_matches_the_cpu``
(B 3, T 50, U 9, S 3, a zero-length row), at simple scale 0 and 0.25: on
the card through the kernels, with the band beta also in one chunk; and on
the CPU with the band alpha's plain sweep in float64 and the band beta's in
float32 or float64.  For each pair it prints the largest |a - b| / (1e-4 +
1e-4 |b|) over the losses and every gradient (the test's tolerance is 1),
and the band beta kernel's and the float32 plain sweep's largest errors
against the float64 plain sweep on the inputs the loss hands them; then the
card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
from transformer_transducer_tpu_torch.ops.cuda import band_kernel as bk


def _plain_beta(dtype):
    return lambda lp_b, lp_l, d, tf, sf, s: bk.band_beta_plain(
        lp_b.to(dtype), lp_l.to(dtype), d, tf, sf).float()


def _run(dev, simple_scale, alpha, beta):
    """Losses and gradients of the test's problem with the band sweeps
    ``alpha`` and ``beta``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, tlen, u, d, inner, v = 3, 50, 9, 16, 24, 40
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    tensors = [mk(b, tlen, d), mk(b, u + 1, d), mk(d, inner), mk(d, inner), mk(inner),
               mk(inner, v), mk(v)]
    labels = torch.randint(1, v, (b, u), generator=gen, device="cuda")
    t_len, u_len = torch.tensor([50, 0, 31]), torch.tensor([9, 4, 6])
    saved = rp.band_alpha, rp.band_beta
    rp.band_alpha, rp.band_beta = alpha, beta
    try:
        leaves = [x.detach().to(dev).requires_grad_() for x in tensors]
        losses = rp.rnnt_loss_pruned(leaves[0], leaves[1], leaves[2:], labels.to(dev), t_len,
                                     u_len, s_range=3, chunk_size=16, reduction="none",
                                     simple_scale=simple_scale)
        grads = torch.autograd.grad(losses.sum(), leaves)
    finally:
        rp.band_alpha, rp.band_beta = saved
    return [losses.detach().cpu()] + [g.cpu() for g in grads]


def _ratio(got, ref):
    return max(((x - y).abs() / (1e-4 + 1e-4 * y.abs())).max().item()
               for x, y in zip(got, ref))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    kernel_beta = rp.band_beta
    alpha64 = lambda lp_b, lp_l, d, s: bk.band_alpha_plain(lp_b.double(), lp_l.double(),
                                                            d).float()
    errs = {}

    def watched_beta(lp_b, lp_l, d, tf, sf, s):
        """The kernel, with its and the float32 sweep's errors read."""
        got = kernel_beta(lp_b, lp_l, d, tf, sf, s)
        ref = _plain_beta(torch.float64)(lp_b, lp_l, d, tf, sf, s)
        f32 = _plain_beta(torch.float32)(lp_b, lp_l, d, tf, sf, s)
        err = lambda x: (x.clamp(min=rp.NEG) - ref.clamp(min=rp.NEG)).abs().max().item()
        errs.update(kernel=err(got), plain_f32=err(f32))
        return got

    one_chunk = lambda lp_b, lp_l, d, tf, sf, s: bk._launch_beta(lp_b, lp_l, d, tf, sf, 1)
    for scale in (0.0, 0.25):
        card = {"kernels": _run("cuda", scale, rp.band_alpha, watched_beta),
                "kernels, beta in one chunk": _run("cuda", scale, rp.band_alpha, one_chunk)}
        cpu = {"beta float32": _run("cpu", scale, alpha64, _plain_beta(torch.float32)),
               "beta float64": _run("cpu", scale, alpha64, _plain_beta(torch.float64))}
        print(f"simple scale {scale}: band beta's largest error against float64: kernel "
              f"{errs['kernel']:.3e}, float32 plain sweep {errs['plain_f32']:.3e}")
        for name, got in card.items():
            print(f"  card {name}: vs the CPU with the " + ", with the ".join(
                f"{ref_name} {_ratio(got, ref):.3f}" for ref_name, ref in cpu.items()))
        print(f"  CPU beta float32 vs CPU beta float64: "
              f"{_ratio(cpu['beta float32'], cpu['beta float64']):.3f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
