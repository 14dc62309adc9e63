"""Input checks and launches shared by the rel-attention wrappers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from transformer_transducer_tpu_torch.ops.cuda import build

HALO = 64   # band bound of the banded kernels: 0 <= left, right <= HALO


def check_inputs(q, k, v, r_emb, r_w_bias, r_bias) -> None:
    """Shapes and dtype every device takes: q, k, v (B, T, H, Dh); r_emb
    (T, H, Dh); r_w_bias (H, Dh); r_bias (T, H); all float32 on one device."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, Dh), got {tuple(q.shape)}")
    b, t, h, dh = q.shape
    want = {"q": (q, (b, t, h, dh)), "k": (k, (b, t, h, dh)),
            "v": (v, (b, t, h, dh)), "r_emb": (r_emb, (t, h, dh)),
            "r_w_bias": (r_w_bias, (h, dh)), "r_bias": (r_bias, (t, h))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def row_stride(x: torch.Tensor, name: str) -> int:
    """Row stride of a (B, T, H, Dh) tensor whose heads are packed: the
    kernels take strided views of the fused qkv projection in place."""
    b, t, h, dh = x.shape
    s = x.stride()
    if s[3] != 1 or s[2] != dh or s[0] != t * s[1] or s[1] % 4 != 0:
        raise ValueError(f"{name} needs packed heads and a row stride that is "
                         f"a multiple of 4, got strides {s}")
    return s[1]


def _aligned(x: torch.Tensor, name: str) -> None:
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for float4 loads")


def kernel_args(q, k, v, r_emb, r_w_bias, r_bias):
    """Pointers and strides for a launch; raises on what the kernels do not
    take (a CPU or non-contiguous table, a head width the kernels are not
    built for, a pointer that is not 16-byte aligned)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    dims = build.head_dims()
    if q.shape[-1] not in dims:
        raise ValueError(f"the attention kernels take Dh in {dims}, got {q.shape[-1]}")
    strides = [row_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    for x, name in ((r_emb, "r_emb"), (r_w_bias, "r_w_bias"), (r_bias, "r_bias")):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (r_emb, "r_emb"),
                    (r_w_bias, "r_w_bias")):
        _aligned(x, name)
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr()] + strides
            + [r_emb.data_ptr(), r_w_bias.data_ptr(), r_bias.data_ptr()])


def launch_forward(fn: str, inputs: Sequence[torch.Tensor], band: Tuple[int, ...],
                   with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor], bool]:
    """Run forward kernel ``fn`` (``ttx_banded_attention_fwd`` or
    ``ttx_flash_rel_attention_fwd``) on
    ``inputs = (q, k, v, r_emb, r_w_bias, r_bias)``.  Returns the output
    (B, T, H, Dh), the row log-sum-exp (B, H, T) the backward needs (when
    ``with_lse``) and whether a kernel was launched (not for empty inputs)."""
    ptrs = kernel_args(*inputs)
    lib = build.library()
    q = inputs[0]
    b, t, h, dh = q.shape
    out = torch.empty((b, t, h, dh), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse, False
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(getattr(lib, fn)(*ptrs, out.data_ptr(),
                                 None if lse is None else lse.data_ptr(),
                                 b, t, h, dh, *band, stream), fn)
    return out, lse, True


def launch_backward(fn: str, saved: Sequence[torch.Tensor], grad: torch.Tensor,
                    band: Tuple[int, ...],
                    scratch: Optional[int] = None) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """Run backward kernel ``fn`` on ``saved = (q, k, v, r_emb, r_w_bias,
    r_bias, out, lse)`` and the output gradient.  Returns the gradients of
    the six inputs (q, k, v contiguous; tables as sliced) and whether a
    kernel was launched.

    Without ``scratch`` the kernel adds into the gradients, which start at
    zero.  With it, the kernel writes every gradient entry once (they start
    uninitialised) and takes a float32 work buffer of ``scratch`` floats
    after them."""
    q, k, v, r_emb, r_w_bias, r_bias, out, lse = saved
    if lse is None:
        raise RuntimeError("the forward kept no row statistics: it ran with "
                           "no input that requires a gradient")
    grad = grad.contiguous()
    if grad.dtype != torch.float32 or grad.shape != out.shape:
        raise ValueError(f"the output gradient must be float32 {tuple(out.shape)}")
    ptrs = kernel_args(q, k, v, r_emb, r_w_bias, r_bias)
    lib = build.library()
    _aligned(grad, "the output gradient")
    like = (out, out, out, r_emb, r_w_bias, r_bias)
    if out.numel() == 0:
        return tuple(torch.zeros_like(x) for x in like), False
    alloc = torch.zeros_like if scratch is None else torch.empty_like
    grads = tuple(alloc(x) for x in like)
    work = (None if scratch is None else
            torch.empty(scratch, dtype=torch.float32, device=q.device))
    b, t, h, dh = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(getattr(lib, fn)(*ptrs, out.data_ptr(), lse.data_ptr(),
                                 grad.data_ptr(), *(g.data_ptr() for g in grads),
                                 *([] if work is None else [work.data_ptr()]),
                                 b, t, h, dh, *band, stream), fn)
    return grads, True
