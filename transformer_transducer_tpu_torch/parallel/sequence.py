"""Sequence parallelism for the banded encoder: time shards with halo
exchange on ``torch.distributed`` (port of ``parallel/sequence.py``).

The streaming band limits every encoder layer's receptive field to ``[i -
left, i + right]`` frames, so the time axis splits over the ranks of a seq
group (``parallel/mesh.py``) with only ``left + right`` frames of
neighbour exchange a layer: shard ``s`` holds frames ``[s·T/n, (s+1)·T/n)``,
sends its last ``left`` frames to shard ``s + 1`` and its first ``right``
frames to shard ``s - 1``, lays ``[left halo | its frames | right halo]``
into a window of ``window_len`` rows, runs the layer under
``context_mask(window_len, left, right)`` and keeps its own rows.  The first
shard's window starts at its own frames (no left halo), and the last
shard's right halo is zero rows: frames past the sequence's end are zero,
as the streaming session's last window sees them.

The halo is :class:`_Halo`, a ``torch.autograd.Function``: its forward
sends and receives over the two-rank link groups of adjacent shards, and
its backward sends each received halo's gradient back to the shard it came
from, which adds it into its gradient of the rows it sent (``ppermute``'s
transpose).  A link's transfer is a broadcast from its sender, which gloo
runs on CUDA tensors as NCCL does.  Every rank posts its links in one
order (even links before odd ones, and within a link the lower shard's
payload first), so no cycle can wait on itself.

Native family (:func:`encode_banded_sp`): the windows are pinned to
``window_len`` rows (default :func:`pinned_window_len`) and the
rel-position tables are sliced at that length, the framework's
pinned-window rule (JAX's ``docs/DESIGN.md`` §2): the result is invariant
in the shard count, and equals :func:`encode_banded_sp_oracle`, not the
one-process banded encoder, whose tables are sliced at T.  The layers run
the attention's masked einsum branch (a mask and no band), as JAX's
``layer_mod.apply(lp, window, mask)`` does, so the banded kernels do not
run inside the shards; under tensor parallelism the layers' own
collectives run in the model group, and the halos carry the full-width
rows every model rank holds.

Espnet family (:func:`encode_banded_sp_espnet`): the signed sinusoidal
rel-pos encoding is shift-invariant, so a window computes exactly the
whole sequence's banded attention for its rows: the result equals
``model.encode`` up to float reassociation, pad masks included.  The input
layer, the sqrt(d) scale and the positional dropout run on the whole
sequence before the shards (each rank takes its rows of the result), and
``after_norm`` on the whole sequence after :func:`gather_seq`.

:func:`gather_seq` rebuilds the whole time axis on every rank of the seq
group (an all-reduce of zero-padded slices: exact but for the sign of a
zero); its backward keeps the rank's own slice and sums nothing, since
every seq rank computes the same loss from the same whole encoding.

Dropout: in train mode each (seq shard, layer) runs under a seed drawn
once a call from the explicit ``generator`` (seeded by the data index, so
the ranks of a model group draw alike) plus the shard and the layer.  JAX
folds (shard, layer) into its key; any iid masks are equally valid (JAX's
docstring), so parity runs use dropout 0.  The layers are not
recomputed in the backward (JAX builds its window layers without remat).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.nn import functional as F

from transformer_transducer_tpu_torch.ops.masks import context_mask
from transformer_transducer_tpu_torch.parallel.mesh import Mesh
from transformer_transducer_tpu_torch.parallel.pipeline import _seeded, encoder_layers


def pinned_window_len(left: int, shard: int, right: int) -> int:
    """Default window pin: the shard plus halos, rounded up to a multiple
    of 64 (the streaming session's rule)."""
    return -(-(left + shard + right) // 64) * 64


def _link(tensor: torch.Tensor, src: int, group) -> None:
    """One halo transfer: ``tensor`` (the sender's, or the receiver's
    buffer) broadcast from world rank ``src`` over the link ``group``."""
    dist.broadcast(tensor, src=src, group=group)


def _exchange(h: torch.Tensor, mesh: Mesh, down: Optional[torch.Tensor],
              up: Optional[torch.Tensor], n_down: int, n_up: int):
    """One exchange over this rank's links: ``down`` (``n_down`` rows) goes
    to the next shard and ``up`` (``n_up`` rows) to the previous one;
    returns ``(from_prev, from_next)``, the ``n_down`` rows the previous
    shard sent and the ``n_up`` rows the next one sent (zeros at the ends).
    ``h`` gives the rows' batch, width, dtype and device."""
    b, _, d = h.shape
    from_prev = h.new_zeros((b, n_down, d))
    from_next = h.new_zeros((b, n_up, d))
    s, ranks = mesh.seq_rank, mesh.seq_ranks
    links = []
    if s > 0:
        links.append(s - 1)
    if s < mesh.n_seq - 1:
        links.append(s)
    for k in sorted(links, key=lambda k: (k % 2, k)):
        lower = k == s                   # this rank sends down on link k
        group = mesh.next_seq_link if lower else mesh.prev_seq_link
        if n_down:
            buf = down.contiguous() if lower else from_prev
            _link(buf, ranks[k], group)
        if n_up:
            buf = from_next if lower else up.contiguous()
            _link(buf, ranks[k + 1], group)
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    """``(left halo, right halo)`` of this shard ``h``: the previous
    shard's last ``left`` rows (zeros on the first shard) and the next
    shard's first ``right`` rows (zeros on the last)."""

    @staticmethod
    def forward(ctx, h, mesh, left, right):
        shard = h.shape[1]
        ctx.mesh, ctx.left, ctx.right, ctx.shard = mesh, left, right, shard
        return _exchange(h, mesh, h[:, shard - left:] if left else None,
                         h[:, :right] if right else None, left, right)

    @staticmethod
    def backward(ctx, g_left, g_right):
        # each halo's gradient goes back to the shard that sent it, which
        # adds it into its gradient of the rows it sent; the first shard's
        # left halo and the last shard's right halo were zeros: theirs drop
        mesh, left, right, shard = ctx.mesh, ctx.left, ctx.right, ctx.shard
        g_first, g_last = _exchange(g_left, mesh, g_right if right else None,
                                    g_left if left else None, right, left)
        b, _, d = g_left.shape
        grad = g_left.new_zeros((b, shard, d))
        grad[:, :right] += g_first
        grad[:, shard - left:] += g_last
        return grad, None, None, None


def halo(h: torch.Tensor, mesh: Mesh, left: int, right: int):
    """The left and right halos of this rank's shard ``h`` (B, shard, D)
    (:class:`_Halo`; zeros with one shard)."""
    if not mesh.sequence_parallel:
        b, _, d = h.shape
        return h.new_zeros((b, left, d)), h.new_zeros((b, right, d))
    return _Halo.apply(h, mesh, left, right)


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole time axis from every seq rank's shard ``x``: each rank
    writes its rows into zeros and an all-reduce sums them."""
    b, shard, d = x.shape
    full = x.new_zeros((b, shard * mesh.n_seq, d))
    full[:, mesh.seq_rank * shard:(mesh.seq_rank + 1) * shard] = x
    dist.all_reduce(full, group=mesh.seq_group)
    return full


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.shard = mesh, x.shape[1]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.seq_rank * ctx.shard
        return g[:, start:start + ctx.shard].contiguous(), None


def gather_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(B, T, D)`` on every rank of the seq group from each rank's
    ``(B, T/n, D)`` shard (the identity with one shard); the backward keeps
    this rank's slice of the gradient."""
    if not mesh.sequence_parallel:
        return x
    return _GatherSeq.apply(x, mesh)


def _geometry(t: int, n: int, left: int, right: int, window_len: Optional[int],
              what: str = "T") -> Tuple[int, int]:
    """JAX's checks: ``(shard, window)``."""
    if t % n:
        raise ValueError(f"{what}={t} must divide over {n} shards")
    shard = t // n
    if shard < max(left, right):
        raise ValueError(f"shard {shard} must cover the halo "
                         f"(left {left} / right {right})")
    w = window_len or pinned_window_len(left, shard, right)
    if w < left + shard + right:
        raise ValueError(f"window_len {w} < left+shard+right "
                         f"{left + shard + right}")
    return shard, w


def _dropout_base(model, generator: Optional[torch.Generator]) -> Optional[int]:
    """The call's dropout seed from ``generator`` in train mode (None in
    eval mode); train mode without a generator raises JAX's error."""
    if not model.training:
        return None
    if generator is None:
        raise ValueError("deterministic=False requires a dropout_rng (a torch.Generator)")
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


def _run_shards(layers, h: torch.Tensor, mesh: Mesh, left: int, right: int, w: int,
                base: Optional[int], apply) -> torch.Tensor:
    """This rank's shard ``h`` through ``layers``: a layer's window is
    ``[left halo | h | right halo]`` (the first shard's without its left
    halo) padded with zero rows to ``w``; ``apply(layer, window)`` runs it,
    and the shard keeps its own rows."""
    s, shard = mesh.seq_rank, h.shape[1]
    off = 0 if s == 0 else left
    for i, layer in enumerate(layers):
        lh, rh = halo(h, mesh, left, right)
        body = torch.cat([h, rh] if s == 0 else [lh, h, rh], 1)
        window = F.pad(body, (0, 0, 0, w - body.shape[1]))
        seed = None if base is None else base + 1 + s * len(layers) + i
        with _seeded(seed, h.device):
            out = apply(layer, window)
        h = out[:, off:off + shard]
    return h


def encode_banded_sp(model, x: torch.Tensor, mesh: Mesh, left: int, right: int,
                     window_len: Optional[int] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Banded encode of ``x`` (B, T, D) with T sharded over the seq group
    (see the module's docstring): each rank runs its ``T/n`` frames, and
    every rank returns the whole ``(B, T, D)`` encoding.  ``generator``
    seeds the layers' dropout in train mode (required there)."""
    b, t, d = x.shape
    shard, w = _geometry(t, mesh.n_seq, left, right, window_len)
    base = _dropout_base(model, generator)
    mask = context_mask(w, left, right, device=x.device)
    start = mesh.seq_rank * shard
    h = _run_shards(encoder_layers(model), x[:, start:start + shard], mesh, left, right, w,
                    base, lambda layer, window: layer(window, mask))
    return gather_seq(h, mesh)


def encode_banded_sp_espnet(model, xs: torch.Tensor, lengths, mesh: Mesh,
                            window_len: Optional[int] = None,
                            generator: Optional[torch.Generator] = None):
    """Espnet-family banded encode with the model-rate time axis sharded
    over the seq group: ``(enc (B, T', D), out_lengths)`` on every rank,
    equal to ``model.encode`` and ``model.encoded_lengths`` up to float
    reassociation (see the module's docstring).  A window's keys are
    masked by the band and by absolute-position validity: real window
    content, inside the row's length and the sequence."""
    from transformer_transducer_tpu_torch.models.espnet_variant import _pos_table
    enc = model.encoder
    left, right = model.encoder_left_mask, model.encoder_right_mask
    if left < 0 or right < 0:
        raise ValueError("espnet sequence parallelism needs a finite band "
                         "(model.mask.encoder_left_mask/right_mask >= 0)")
    base = _dropout_base(model, generator)
    x, lens = enc.input_transform(xs, lengths)
    b, t, _ = x.shape
    shard, w = _geometry(t, mesh.n_seq, left, right, window_len, "model-rate T")
    d, dev = enc.output_size, x.device
    x = enc.pos_drop(x * math.sqrt(d))
    pos = enc.pos_drop_emb(_pos_table(w, d, dev).to(x.dtype))
    s = mesh.seq_rank
    off = 0 if s == 0 else left
    # window slot k holds frame s*shard + k - off; a key is valid where it
    # is the window's content and inside the row's length (the dp path's
    # key-side pad mask, window-relative); the band does the rest
    k = torch.arange(w, device=dev)[None, :]
    abs_pos = s * shard + k - off
    content = k < off + shard + right
    valid = (torch.as_tensor(lens, device=dev)[:, None].clamp(max=t) if lens is not None
             else torch.full((b, 1), t, device=dev))
    key_bad = ~content | (abs_pos >= valid) | (abs_pos < 0)
    mask = context_mask(w, left, right, device=dev)[None] | key_bad[:, None, :]
    h = _run_shards(enc.encoders, x[:, s * shard:(s + 1) * shard], mesh, left, right, w, base,
                    lambda layer, window: layer(window, pos, mask))
    return enc.after_norm(gather_seq(h, mesh)), lens


def encode_banded_sp_oracle(model, x: torch.Tensor, n: int, left: int, right: int,
                            window_len: Optional[int] = None) -> torch.Tensor:
    """One process's layer-by-layer yardstick of :func:`encode_banded_sp`
    over ``n`` shards: each shard's window cut from the whole sequence
    (zero rows past its end), no collective; differentiable.  Dropout is
    the model's (the yardstick runs at dropout 0)."""
    b, t, d = x.shape
    shard, w = _geometry(t, n, left, right, window_len)
    mask = context_mask(w, left, right, device=x.device)
    h = x
    for layer in encoder_layers(model):
        padded = F.pad(h, (0, 0, 0, right))
        outs = []
        for s in range(n):
            start = s * shard
            lo = max(0, start - left)
            window = padded[:, lo:start + shard + right]
            out = layer(F.pad(window, (0, 0, 0, w - window.shape[1])), mask)
            outs.append(out[:, start - lo:start - lo + shard])
        h = torch.cat(outs, 1)
    return h
