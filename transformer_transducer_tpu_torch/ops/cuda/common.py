"""Input checks and launch arguments shared by the rel-attention wrappers."""

from __future__ import annotations

import torch

HALO = 64   # band bound of the banded kernel: 0 <= left, right <= HALO


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


def kernel_args(q, k, v, r_emb, r_w_bias, r_bias, head_dim: int):
    """Pointers and strides for a launch; raises on what the kernels do not
    take (a CPU or non-contiguous table, another head width, a pointer that
    is not 16-byte aligned)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    if q.shape[-1] != head_dim:
        raise ValueError(f"the kernel takes Dh == {head_dim}, got {q.shape[-1]}")
    strides = [row_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    for x, name in ((r_emb, "r_emb"), (r_w_bias, "r_w_bias"), (r_bias, "r_bias")):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (r_emb, "r_emb"),
                    (r_w_bias, "r_w_bias")):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for float4 loads")
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr()] + strides
            + [r_emb.data_ptr(), r_w_bias.data_ptr(), r_bias.data_ptr()])
