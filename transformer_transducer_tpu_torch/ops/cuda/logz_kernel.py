"""The additive-joint partition function: CUDA kernel + plain version.

``logZ[b, t, u] = logsumexp_v(A[b, t, v] + L[b, u, v])``, the normalizer of
the pruned loss's linearized joint (``ops/rnnt_loss_pruned.py::
simple_grid_logprobs``).  Replaces the TPU kernel
``ops/pallas/logz_kernel.py::_logz_pallas``; the kernel is
``ttx_additive_logz`` in ``csrc/additive_logz.cu``, which documents the bound
and the design: the product ``exp(A - max) . exp(L - max)^T`` on the tensor
cores in 3xTF32, with an underflow certificate and an exact pass for the
cells it does not cover.  Four launches a call, all on the caller's stream,
with no host read; the workspace is allocated here.  Output layout (B, T,
U1): the TPU's (B, U1, T) lane layout and its padding are not carried over.

:func:`additive_logz` is differentiable.  Its forward takes the kernel on a
CUDA tensor (or raises) and :func:`additive_logz_plain` on a CPU tensor; its
backward is plain PyTorch on both (the JAX package's ``_additive_logz_bwd``,
a loop over u; the JAX package has no Pallas backward either).
``additive_logz.launches`` counts kernel calls (one a call, whose four
launches are one kernel); :func:`marked_cells` reads how many cells the
last call left to the exact pass.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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


@functools.lru_cache(maxsize=None)
def plan(device: int, b: int, t: int, u1: int, v: int) -> Tuple[int, int, int, int]:
    """The kernel's plan for a shape on a CUDA device: (4-byte words of its
    workspace, slices of V, offset and number of the per-block counts of
    marked cells in the workspace)."""
    info = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        words = build.library().ttx_additive_logz_workspace(b, t, u1, v, info)
    if words < 0:
        build.check(-words, "ttx_additive_logz_workspace")
    return words, info[0], info[3], info[2]


# the last call's workspace, kept until the next call, and where its counts
# lie (read by marked_cells)
_last: Optional[Tuple[torch.Tensor, int, int]] = None


def _launch(a_grid: torch.Tensor, l_grid: torch.Tensor) -> torch.Tensor:
    """``ttx_additive_logz`` on contiguous fp32 CUDA grids."""
    global _last
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
    words, _, counts, n_counts = plan(a.device.index, b, t, u1, v)
    work = torch.empty(words, dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    build.check(lib.ttx_additive_logz(a.data_ptr(), l.data_ptr(), out.data_ptr(),
                                      work.data_ptr(), b, t, u1, v, stream),
                "ttx_additive_logz")
    additive_logz.launches += 1
    _last = (work, counts, n_counts)
    return out


def marked_cells() -> int:
    """Cells the last kernel call left to its exact pass (those the
    product's underflow certificate did not cover).  Reads the device, so
    it synchronises: for tests and measurements, never the main path."""
    if _last is None:
        raise RuntimeError("additive_logz has not run on a CUDA tensor")
    work, counts, n = _last
    return int(work[counts:counts + n].view(torch.int32).sum())


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
