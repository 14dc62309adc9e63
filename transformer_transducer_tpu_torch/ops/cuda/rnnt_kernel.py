"""RNN-T lattice sweeps (alpha forward, beta' backward): CUDA kernels + plain
versions.

Replaces the TPU kernels ``ops/pallas/rnnt_kernel.py::alpha_scan_pallas``
(``_alpha_kernel``) and ``beta_scan_pallas`` (``_beta_kernel``).  Same
contract: pre-skewed, diagonal-major (B, D = T + U1 - 1, U1) float32 grids in
and out (``ops/rnnt_loss.py::_skew``).  The kernels are ``ttx_rnnt_alpha`` /
``ttx_rnnt_beta`` in ``csrc/rnnt_lattice.cu``, which documents the
recurrences, the bound and the design.

Dispatch: a CPU tensor takes :func:`alpha_scan_plain` /
:func:`beta_scan_plain` (the eager scans of the JAX module); a CUDA tensor
launches the kernel or raises.  ``alpha_scan.launches`` and
``beta_scan.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from transformer_transducer_tpu_torch.ops.cuda import build

NEG = -1e30


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max + log1p(exp(-|a - b|))``: finite for two ``NEG`` operands."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _neg_column(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x[..., :1], NEG)


def alpha_scan_plain(skew_b: torch.Tensor, skew_l: torch.Tensor) -> torch.Tensor:
    """Forward lattice pass (the JAX package's ``ops/rnnt_loss.py::
    _alpha_scan``): diag-major alpha (B, D, U1)."""
    a = torch.full_like(skew_b[:, 0], NEG)
    a[:, 0] = 0.0
    rows = [a]
    for d in range(1, skew_b.shape[1]):
        label = a + skew_l[:, d - 1]
        label = torch.cat([_neg_column(label), label[:, :-1]], dim=-1)
        a = logaddexp(a + skew_b[:, d - 1], label)
        rows.append(a)
    return torch.stack(rows, dim=1)


def beta_scan_plain(skew_b: torch.Tensor, skew_l: torch.Tensor,
                    inject: torch.Tensor) -> torch.Tensor:
    """Backward lattice pass (the JAX package's ``ops/rnnt_loss.py::
    _beta_scan``): diag-major beta' (B, D, U1) from the terminal ``inject``
    (NEG off the terminal cell)."""
    nb = torch.full_like(skew_b[:, 0], NEG)
    rows = []
    for d in range(skew_b.shape[1] - 1, -1, -1):
        up = torch.cat([nb[:, 1:], _neg_column(nb)], dim=-1)
        nb = logaddexp(logaddexp(skew_b[:, d] + nb, skew_l[:, d] + up),
                       inject[:, d])
        rows.append(nb)
    return torch.stack(rows[::-1], dim=1)


def _check(name: str, *grids: torch.Tensor) -> None:
    shape = grids[0].shape
    for x in grids:
        if x.dim() != 3 or x.shape != shape:
            raise ValueError(f"{name}: grids must share one (B, D, U1) shape, "
                             f"got {[tuple(g.shape) for g in grids]}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: grids must be float32, got {x.dtype}")
        if x.device != grids[0].device:
            raise ValueError(f"{name}: grids on different devices")


def _launch_args(grids):
    lib = build.library()
    b, d, u1 = grids[0].shape
    if grids[0].device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {grids[0].device}")
    if u1 > lib.ttx_rnnt_max_u1():
        raise ValueError(f"the lattice kernels take U1 <= {lib.ttx_rnnt_max_u1()}, "
                         f"got {u1}")
    grids = [g.contiguous() for g in grids]
    stream = torch.cuda.current_stream(grids[0].device).cuda_stream
    return lib, grids, (b, d, u1), stream


def alpha_scan(skew_b: torch.Tensor, skew_l: torch.Tensor) -> torch.Tensor:
    """Diag-major alpha (B, D, U1) from pre-skewed blank/label grids."""
    _check("alpha_scan", skew_b, skew_l)
    if skew_b.device.type == "cpu":
        return alpha_scan_plain(skew_b, skew_l)
    lib, (sb, sl), (b, d, u1), stream = _launch_args((skew_b, skew_l))
    out = torch.empty_like(sb)
    if out.numel() == 0:
        return out
    build.check(lib.ttx_rnnt_alpha(sb.data_ptr(), sl.data_ptr(), out.data_ptr(),
                                   b, d, u1, stream), "ttx_rnnt_alpha")
    alpha_scan.launches += 1
    return out


def beta_scan(skew_b: torch.Tensor, skew_l: torch.Tensor,
              inject: torch.Tensor) -> torch.Tensor:
    """Diag-major beta' (B, D, U1) from pre-skewed grids + terminal inject."""
    _check("beta_scan", skew_b, skew_l, inject)
    if skew_b.device.type == "cpu":
        return beta_scan_plain(skew_b, skew_l, inject)
    lib, (sb, sl, inj), (b, d, u1), stream = _launch_args((skew_b, skew_l, inject))
    out = torch.empty_like(sb)
    if out.numel() == 0:
        return out
    build.check(lib.ttx_rnnt_beta(sb.data_ptr(), sl.data_ptr(), inj.data_ptr(),
                                  out.data_ptr(), b, d, u1, stream),
                "ttx_rnnt_beta")
    beta_scan.launches += 1
    return out


alpha_scan.launches = 0
beta_scan.launches = 0
