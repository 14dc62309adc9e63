"""Int8 serving, W8A8 with dynamic activation scales (port of
``ops/quant.py``).

The scheme is the JAX package's, step for step:

* **Weights**: symmetric per-output-channel int8.  A ``Linear.weight``
  (out, in) becomes ``weight_q = round(w / s_w)`` with
  ``s_w[out] = max|w[out, :]| * (1/127)`` (the JAX kernel is (in, out),
  its transpose).
* **Activations**: symmetric per-row int8, scales computed on the fly:
  ``s_a = max|x_row| * (1/127)``.
* **Product**: int8 x int8 -> int32, exact, then ``y.float() * s_a *
  scale`` in that order, the last product and the bias in one fused
  multiply-add.  ``round`` is half-to-even in both packages.

Only the projections the JAX model routes through ``make_dense`` are
quantised (``PROJECTIONS``): in the native family the attention's ``qkv``
and ``out``, the FFN's ``fc1`` and ``fc2`` and the joint's
``forward_layer`` and ``project_layer``; in the espnet family every
``Linear`` (``linear_pos`` too, on the position table).  The attention
einsums, LayerNorms, embeddings, convolutions, position tables,
``r_bias`` and a tied output projection (the embedding table) stay
float.

On the card the int8 product is ``torch._int_mm`` (the JAX package
computes it with ``lax.dot_general`` outside any Pallas kernel); on the
CPU it is an int32 matmul.  The quantise steps are plain tensor code, as
they are in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

INT8_MAX = 127.0
# XLA folds the division by the constant 127 into a product with its
# float32 reciprocal in every compiled program (``quantize_params`` is
# jitted, the decoders and sessions trace), so the scales are that
# product here too; an op-by-op JAX call divides, and its scales may
# differ from the compiled ones by an ulp
INV_INT8_MAX = 1.0 / INT8_MAX
# the module names of the projections the JAX models build with
# make_dense: in a native Transducer qkv, out, fc1 and fc2 of each layer and
# the joint's two layers; in an EspnetTransducer the attention's q, k, v,
# out and bias-free pos, the FFN's w_1 and w_2, the joint's three layers,
# the "linear" input layer's projection (embed.0; the "embed" input layer's
# embed.0 is an embedding and stays float) and a conv stack's out.0 (its
# convolutions stay float)
PROJECTIONS = ("qkv_net", "o_net", "CoreNet.0", "CoreNet.3", "forward_layer",
               "project_layer", "linear_q", "linear_k", "linear_v", "linear_out",
               "linear_pos", "w_1", "w_2", "lin_enc", "lin_dec", "lin_out",
               "embed.0", "out.0")


def is_projection(name: str) -> bool:
    """Whether the module at the qualified ``name`` is quantised when it is
    a ``Linear`` (``embed.0`` may be an embedding)."""
    return any(name == p or name.endswith("." + p) for p in PROJECTIONS)


def is_projection_weight(state, key: str) -> bool:
    """Whether ``key`` of a float state dict is a projection's weight: an
    ``embed.0`` weight is one only beside a bias (the "linear" input
    layer's; the "embed" layer's table has none)."""
    name, _, leaf = key.rpartition(".")
    if leaf != "weight" or not is_projection(name):
        return False
    return not (name == "embed.0" or name.endswith(".embed.0")) or name + ".bias" in state


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a ``Linear.weight`` (out, in):
    ``(weight_q int8 (out, in), scale float32 (out,))`` with
    ``weight_q * scale[:, None]`` close to ``weight``."""
    w = weight.detach().to(torch.float32)
    scale = w.abs().amax(dim=1).clamp(min=1e-30) * INV_INT8_MAX
    w_q = torch.round(w / scale[:, None]).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return w_q, scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: ``(x_q int8, s_a float32 (..., 1))``."""
    absmax = x.to(torch.float32).abs().amax(dim=-1, keepdim=True)
    s_a = absmax.clamp(min=1e-30) * INV_INT8_MAX
    x_q = torch.round(x / s_a).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return x_q, s_a


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_weight(w_q: torch.Tensor) -> torch.Tensor:
    """``w_q`` (N, K) padded with zeros to N and K multiples of 8, the
    shapes ``torch._int_mm``'s CUDA form takes (``w_q`` itself where they
    are already).  A constant weight's is made once (``QuantLinear``)."""
    n, k = w_q.shape
    if n % 8 == 0 and k % 8 == 0:
        return w_q
    return nn.functional.pad(w_q, (0, _round_up(k, 8) - k, 0, _round_up(n, 8) - n))


def int_mm_operands(x_q: torch.Tensor, w_q: torch.Tensor,
                    w_mm: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x_q`` (M, K) and ``w_q`` (N, K) padded with zeros to the shapes
    ``torch._int_mm``'s CUDA form takes: more than 16 rows (24 at least,
    a multiple of 8) and K and N multiples of 8.  The weight's is
    ``w_mm`` where it was made ahead (``int_mm_weight``); only the
    activation is padded on every call.  A zero adds nothing to an integer
    sum, so the padded product's (M, N) corner is the exact product.
    Returns ``(a (Mp, Kp), b (Np, Kp))``."""
    m, k = x_q.shape
    b = int_mm_weight(w_q) if w_mm is None else w_mm
    return nn.functional.pad(x_q, (0, b.shape[1] - k, 0, max(24, _round_up(m, 8)) - m)), b


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                w_mm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) int8 times (N, K)ᵀ int8 -> (M, N) int32, exact: sums of up
    to 2048 products of |127 x 127| pass 2^24, so no float product may
    stand in.  On the card ``torch._int_mm`` on the padded operands
    (``int_mm_operands``; the weight's transpose is column-major, the
    layout cuBLASLt's int8 path takes); on the CPU an int32 matmul."""
    if x_q.is_cuda:
        a, b = int_mm_operands(x_q, w_q, w_mm)
        return torch._int_mm(a, b.t())[:x_q.shape[0], :w_q.shape[0]]
    return x_q.to(torch.int32) @ w_q.to(torch.int32).t()


def quant_dense_apply(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      w_mm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (..., in)`` times the dequantised ``weight_q (out, in)``: the
    activation quantised per row, the int8 product in int32, then
    ``y.float() * s_a * scale`` and the bias.  ``w_mm``: the card's padded
    weight (``int_mm_weight``), if made ahead."""
    x_q, s_a = quantize_activation(x)
    lead = x.shape[:-1]
    y = int8_matmul(x_q.reshape(-1, x.shape[-1]), weight_q, w_mm)
    y = y.reshape(*lead, weight_q.shape[0]).to(torch.float32) * s_a
    if bias is None:
        return y * scale
    # one rounding for the last product and the bias, as XLA's CPU code
    # contracts them into a fused multiply-add (so does addcmul)
    return torch.addcmul(bias, y, scale)


class QuantLinear(nn.Module):
    """The int8 twin of ``nn.Linear`` (JAX ``QuantDense``): buffers
    ``weight_q`` int8 (out, in), ``scale`` float32 (out,) and an optional
    ``bias``; ``in_features`` and ``out_features`` as ``nn.Linear`` has
    them.  Inference only.  On the card the weight padded for
    ``torch._int_mm`` is made on the first call and kept (outside the
    state dict) until ``weight_q`` is replaced or written to."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device)
                             if bias else None)
        self._mm = None                     # (weight_q, its version, padded)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "QuantLinear":
        q = cls(linear.in_features, linear.out_features, linear.bias is not None,
                device=linear.weight.device)
        q.weight_q, q.scale = quantize_weight(linear.weight)
        if linear.bias is not None:
            q.bias = linear.bias.detach().to(torch.float32).clone()
        return q

    def mm_weight(self) -> torch.Tensor:
        """``int_mm_weight(weight_q)``, made again only when ``weight_q`` is
        another tensor (``.to``) or was written to (``load_state_dict``)."""
        w = self.weight_q
        if self._mm is None or self._mm[0] is not w or self._mm[1] != w._version:
            self._mm = (w, w._version, int_mm_weight(w))
        return self._mm[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_dense_apply(x, self.weight_q, self.scale, self.bias,
                                 self.mm_weight() if x.is_cuda else None)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


def dense_kernel(layer: nn.Module) -> torch.Tensor:
    """The float weight (out, in) of a projection (JAX ``dense_kernel``):
    an ``nn.Linear``'s own (a view, so gradients reach it), a
    ``QuantLinear``'s dequantised."""
    if isinstance(layer, QuantLinear):
        return layer.weight_q.to(torch.float32) * layer.scale[:, None]
    return layer.weight


def quantize_modules(model: nn.Module) -> nn.Module:
    """Swap each projection (``PROJECTIONS``) of a ``Transducer`` or an
    ``EspnetTransducer`` for its ``QuantLinear``, in place; everything else
    stays float."""
    for name, module in list(model.named_modules()):
        for child_name, child in list(module.named_children()):
            if is_projection(f"{name}.{child_name}") and isinstance(child, nn.Linear):
                setattr(module, child_name, QuantLinear.from_linear(child))
    return model
