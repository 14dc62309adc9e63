"""Full-context rel-position attention, forward and backward: CUDA kernels
+ plain versions.

Replaces the TPU kernels of ``ops/pallas/flash_rel_attention.py::
flash_rel_attention``: the forward (``_fwd_impl``, ``_fwd_kernel``) and the
backward (``_vjp_bwd``, ``_bwd_kernel``).  Unmasked Transformer-XL attention
with learnable tables, computed per query tile with an online softmax so no
(B, H, T, T) tensor reaches device memory; the backward recomputes the
probabilities from the row log-sum-exp the forward keeps.  The kernels are
``ttx_flash_rel_attention_fwd`` in ``csrc/flash_rel_attention_fwd.cu`` and
``ttx_flash_rel_attention_bwd`` in ``csrc/flash_rel_attention_bwd.cu``; the
products of both run on the TF32 tensor cores in 3xTF32 (fp32 accuracy,
``csrc/tensor_core.cuh``), at head widths 32 and 64.  Each source states
its bounds and design; ``csrc/rel_attention.cu`` documents the score rule.

Two forms, chosen by the inputs' dtype (all six alike):

* float32: the kernels above; the plain version is the dense branch.
* bfloat16 (``--bf16 --flash``): ``ttx_flash_rel_attention_{fwd,bwd}_bf16``
  compute at the Pallas kernels' rounding points, which are not the dense
  branch's: float32 arithmetic on bf16 operands, ``q + u`` rounded to bf16,
  the scores divided by sqrt(Dh) in float32, a float32 softmax, P rounded
  to bf16 before P.V (the output is float32); in the backward dO rounded
  to bf16, D_i = sum_j P_ij dP_ij with the float32 P, dS and P rounded to
  bf16 before every product, and each gradient cast to bf16.  The forward
  also keeps the float32 P's product with v (``sums``) for the backward's
  D.  The products of both run on the bf16 tensor cores
  (``mma.m16n8k16``, operands bf16 in shared memory).  The backward is
  three launches: a pre-pass (dO and ``q + u`` rounded, D, the float32
  sums zeroed), the kernel, whose blocks own 64 keys each and write dk and
  dv once, and the casts of dq and the tables' gradients, summed across
  blocks in float32.  :func:`flash_bf16_forward_plain` and
  :func:`flash_bf16_backward_plain` are the plain versions, the backward
  written out (autograd through the forward would not round dS).

Dispatch: a CPU tensor takes :func:`flash_rel_attention_plain`; a CUDA
tensor runs the kernels behind a ``torch.autograd.Function`` or raises.
``flash_rel_attention.launches`` counts forward launches of both forms and
``flash_rel_attention_backward.launches`` backward launches of both;
``flash_forward_bf16.launches`` and ``flash_backward_bf16.launches`` count
the bf16 forms alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from transformer_transducer_tpu_torch.models.attention import (
    rel_attention_dense, rel_shift)
from transformer_transducer_tpu_torch.ops.cuda import build
from transformer_transducer_tpu_torch.ops.cuda.common import (
    check_inputs, launch_backward, launch_forward)

BF16 = torch.bfloat16


def _round(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(bfloat16)`` held in float32."""
    return x.to(BF16).float()


def _bf16_parts(q, k, r_emb, r_w_bias, r_bias):
    """The scores as the Pallas kernel forms them from bf16 operands:
    ``qu = bf16(q + u)``, ``AC = qu . k``, ``BD = q_sel . re + rb`` (exact
    products, float32 sums), ``(AC + BD) / sqrt(Dh)`` divided in float32.
    Returns float32 q, k, r_emb, r_bias and qu, sqrt(Dh), BD as a function
    of (q, r_emb, r_bias), and the scores (B, H, T, T)."""
    qf, kf, ref, rbf = (x.float() for x in (q, k, r_emb, r_bias))
    qu = _round(qf + r_w_bias.float())
    scale = float(np.sqrt(q.shape[-1]))        # JAX's np.sqrt(dh), divided in float32

    def bd_of(qx, rex, rbx):
        return rel_shift(torch.einsum("bind,jnd->bnij", qx, rex)
                         + rbx.t()[None, :, None, :])
    ac = torch.einsum("bind,bjnd->bnij", qu, kf)
    scores = (ac + bd_of(qf, ref, rbf)) / scale
    return qf, kf, ref, rbf, qu, scale, bd_of, scores


def flash_bf16_forward_plain(q, k, v, r_emb, r_w_bias, r_bias
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 form's forward in plain PyTorch: the float32 output
    ``bf16(P) . v``, the row log-sum-exp (B, H, T) and the float32 P's
    product with v (B, T, H, Dh), from bf16 inputs."""
    *_, scores = _bf16_parts(q, k, r_emb, r_w_bias, r_bias)
    prob = torch.softmax(scores, dim=-1)
    vf = v.float()
    out = torch.einsum("bnij,bjnd->bind", _round(prob), vf)
    sums = torch.einsum("bnij,bjnd->bind", prob, vf)
    return out, torch.logsumexp(scores, dim=-1), sums


def flash_bf16_backward_plain(q, k, v, r_emb, r_w_bias, r_bias, grad
                              ) -> Tuple[torch.Tensor, ...]:
    """The bf16 form's backward in plain PyTorch, as the Pallas backward
    computes it: the gradients of q, k, v, r_emb, r_w_bias, r_bias (tables
    as sliced), each bf16."""
    with torch.no_grad():
        qf, kf, ref, rbf, qu, scale, bd_of, scores = _bf16_parts(
            q, k, r_emb, r_w_bias, r_bias)
        prob = torch.softmax(scores, dim=-1)
        go = _round(grad.float())
        dp = torch.einsum("bind,bjnd->bnij", go, v.float())
        d = (prob * dp).sum(-1, keepdim=True)              # with the float32 P
        ds = _round(prob * (dp - d) / scale)
        p_b = _round(prob)
        dv = torch.einsum("bnij,bind->bjnd", p_b, go)
        dk = torch.einsum("bnij,bind->bjnd", ds, qu)
        dq_ac = torch.einsum("bnij,bjnd->bind", ds, kf)
        du = dq_ac.sum((0, 1))
    # the BD scatter's transpose: its products are bf16 dS against q and re
    leaves = [x.detach().requires_grad_() for x in (qf, ref, rbf)]
    with torch.enable_grad():
        dq_bd, dre, drb = torch.autograd.grad(bd_of(*leaves), leaves, ds)
    return tuple(x.to(BF16) for x in (dq_ac + dq_bd, dk, dv, dre, du, drb))


class _FlashBf16Plain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, r_emb, r_w_bias, r_bias):
        ctx.save_for_backward(q, k, v, r_emb, r_w_bias, r_bias)
        return flash_bf16_forward_plain(q, k, v, r_emb, r_w_bias, r_bias)[0]

    @staticmethod
    def backward(ctx, grad):
        return flash_bf16_backward_plain(*ctx.saved_tensors, grad)


def flash_rel_attention_plain(q, k, v, r_emb, r_w_bias, r_bias) -> torch.Tensor:
    """The plain version of either form: under float32 the dense branch with
    no mask (gradients by autograd), under bf16 the plain bf16 forward with
    the plain bf16 backward.  Returns float32 for bf16 inputs."""
    if q.dtype == BF16:
        return _FlashBf16Plain.apply(q, k, v, r_emb, r_w_bias, r_bias)
    return rel_attention_dense(q, k, v, r_emb, r_w_bias, r_bias)


def flash_rel_attention_backward(q, k, v, r_emb, r_w_bias, r_bias, out, lse,
                                 grad):
    """The float32 backward kernel: gradients of q, k, v, r_emb, r_w_bias,
    r_bias (tables as sliced to T rows) from the forward's inputs, output
    and row log-sum-exp."""
    grads, launched = launch_backward(
        "ttx_flash_rel_attention_bwd",
        (q, k, v, r_emb, r_w_bias, r_bias, out, lse), grad, ())
    flash_rel_attention_backward.launches += int(launched)
    return grads


flash_rel_attention_backward.launches = 0


def flash_forward_bf16(q, k, v, r_emb, r_w_bias, r_bias, with_lse: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """The bf16 forward kernel: the float32 output and, with ``with_lse``,
    the row log-sum-exp and the float32 P's product with v that the bf16
    backward reads."""
    b, t, h, dh = q.shape
    sums = (torch.empty((b, t, h, dh), dtype=torch.float32, device=q.device)
            if with_lse else None)
    out, lse, launched = launch_forward(
        "ttx_flash_rel_attention_fwd_bf16", (q, k, v, r_emb, r_w_bias, r_bias), (),
        with_lse=with_lse, outputs=(sums,))
    flash_forward_bf16.launches += int(launched)
    flash_rel_attention.launches += int(launched)
    return out, lse, sums


flash_forward_bf16.launches = 0


def flash_backward_bf16(q, k, v, r_emb, r_w_bias, r_bias, sums, lse, grad):
    """The bf16 backward kernels: bf16 gradients of the six inputs from the
    forward's float32 P . v sums and row log-sum-exp; the output gradient
    is rounded to bf16 by the kernels' pre-pass, as JAX rounds it."""
    b, t, h, dh = q.shape
    work = build.library().ttx_flash_rel_attention_bwd_bf16_workspace(b, t, h, dh)
    grads, launched = launch_backward(
        "ttx_flash_rel_attention_bwd_bf16",
        (q, k, v, r_emb, r_w_bias, r_bias, sums, lse), grad.float(), (),
        scratch=work, native=True)
    flash_backward_bf16.launches += int(launched)
    flash_rel_attention_backward.launches += int(launched)
    return grads


flash_backward_bf16.launches = 0


class _FlashRelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, r_emb, r_w_bias, r_bias):
        inputs = (q, k, v, r_emb, r_w_bias, r_bias)
        with_lse = any(ctx.needs_input_grad)
        if q.dtype == BF16:
            out, lse, saved = flash_forward_bf16(*inputs, with_lse=with_lse)
        else:
            out, lse, launched = launch_forward(
                "ttx_flash_rel_attention_fwd", inputs, (), with_lse=with_lse)
            flash_rel_attention.launches += int(launched)
            saved = out
        ctx.save_for_backward(*inputs, saved, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        if saved[0].dtype == BF16:
            return flash_backward_bf16(*saved, grad)
        return flash_rel_attention_backward(*saved, grad)


def flash_rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        r_emb: torch.Tensor, r_w_bias: torch.Tensor,
                        r_bias: torch.Tensor) -> torch.Tensor:
    """Full-attention rel-position MHA (pre out-projection), differentiable.

    Args: q/k/v (B, T, H, Dh); tables sliced to T rows
    (``models.attention.slice_pos_table``); all float32 or all bf16.
    Returns (B, T, H, Dh) float32.
    """
    check_inputs(q, k, v, r_emb, r_w_bias, r_bias, dtypes=(torch.float32, BF16))
    if q.device.type == "cpu":
        return flash_rel_attention_plain(q, k, v, r_emb, r_w_bias, r_bias)
    return _FlashRelAttention.apply(q, k, v, r_emb, r_w_bias, r_bias)


flash_rel_attention.launches = 0
