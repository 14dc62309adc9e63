"""The additive-joint partition function: CUDA kernel + plain version.

``logZ[b, t, u] = logsumexp_v(A[b, t, v] + L[b, u, v])``, the normalizer of
the pruned loss's linearized joint (``ops/rnnt_loss_pruned.py::
simple_grid_logprobs``).  Replaces the TPU kernel
``ops/pallas/logz_kernel.py::_logz_pallas``; the kernel is
``ttx_additive_logz`` in ``csrc/rnnt_pruned.cu``, which documents the bound
and the design.  Output layout (B, T, U1): the TPU's (B, U1, T) lane layout
and its padding are not carried over.

:func:`additive_logz` is differentiable.  Its forward takes the kernel on a
CUDA tensor (or raises) and :func:`additive_logz_plain` on a CPU tensor; its
backward is plain PyTorch on both (the JAX package's ``_additive_logz_bwd``,
a loop over u; the JAX package has no Pallas backward either).
``additive_logz.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from transformer_transducer_tpu_torch.ops.cuda import build


def additive_logz_plain(a_grid: torch.Tensor, l_grid: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``additive_logz_xla``: a loop over u of
    ``logsumexp_v(A + L[:, u])`` -> (B, T, U1)."""
    return torch.stack([torch.logsumexp(a_grid + l_grid[:, u, None, :], dim=-1)
                        for u in range(l_grid.shape[1])], dim=-1)


def _check(a_grid: torch.Tensor, l_grid: torch.Tensor) -> None:
    if a_grid.dim() != 3 or l_grid.dim() != 3 or a_grid.shape[0] != l_grid.shape[0] \
            or a_grid.shape[2] != l_grid.shape[2]:
        raise ValueError(f"additive_logz: A must be (B, T, V) and L (B, U1, V), "
                         f"got {tuple(a_grid.shape)} and {tuple(l_grid.shape)}")
    if a_grid.device != l_grid.device:
        raise ValueError("additive_logz: A and L on different devices")


def _launch(a_grid: torch.Tensor, l_grid: torch.Tensor) -> torch.Tensor:
    """``ttx_additive_logz`` on contiguous fp32 CUDA grids."""
    if a_grid.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {a_grid.device}")
    lib = build.library()
    b, t, v = a_grid.shape
    u1 = l_grid.shape[1]
    a = a_grid.float().contiguous()
    l = l_grid.float().contiguous()
    out = torch.empty((b, t, u1), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if v == 0:
        raise ValueError("additive_logz: an empty vocabulary has no normalizer")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    build.check(lib.ttx_additive_logz(a.data_ptr(), l.data_ptr(), out.data_ptr(),
                                      b, t, u1, v, stream), "ttx_additive_logz")
    additive_logz.launches += 1
    return out


class _AdditiveLogZ(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a_grid, l_grid):
        a_grid, l_grid = a_grid.float(), l_grid.float()
        z = (additive_logz_plain(a_grid, l_grid) if a_grid.device.type == "cpu"
             else _launch(a_grid, l_grid))
        ctx.save_for_backward(a_grid, l_grid, z)
        return z

    @staticmethod
    def backward(ctx, g):
        a_grid, l_grid, z = ctx.saved_tensors
        d_a = torch.zeros_like(a_grid)
        d_l = []
        for u in range(l_grid.shape[1]):
            p = torch.exp(a_grid + l_grid[:, u, None, :] - z[:, :, u, None])
            d_a += g[:, :, u, None] * p
            d_l.append(torch.einsum("bt,btv->bv", g[:, :, u], p))
        return d_a, torch.stack(d_l, dim=1)


def additive_logz(a_grid: torch.Tensor, l_grid: torch.Tensor) -> torch.Tensor:
    """``logsumexp_v(A[:, t] + L[:, u])`` -> (B, T, U1) fp32, differentiable."""
    _check(a_grid, l_grid)
    return _AdditiveLogZ.apply(a_grid, l_grid)


additive_logz.launches = 0
