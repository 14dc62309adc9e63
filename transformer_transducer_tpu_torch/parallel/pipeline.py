"""Pipeline parallelism for the audio encoder: GPipe over encoder stages
on ``torch.distributed`` (port of ``parallel/pipeline.py``).

The encoder is N identical layers, so it splits into ``n_pipe`` contiguous
stages of ``N / n_pipe`` layers: stage ``s`` owns layers ``[s·N/n_pipe,
(s+1)·N/n_pipe)``, as JAX's ``stack_encoder_layers`` shards the stacked
layer axis over ``pipe``.  Each rank of a pipe group (``parallel/mesh.py``)
runs one stage; ``parallel/sharding.py::pipe_model`` frees the storage of
the other stages' layers.

The batch (this data rank's rows) splits into ``n_micro`` microbatches of
contiguous rows.  The schedule is JAX's GPipe: stage 0 takes microbatch m,
runs its layers and hands the activation to stage 1, and so on, all the
forwards first (``n_micro + n_pipe - 1`` ticks, a bubble of ``(n_pipe - 1)
/ (n_micro + n_pipe - 1)``), then the backwards in reverse microbatch
order: a stage receives the gradient of its output, runs
``torch.autograd.backward`` on that microbatch's output and hands its
input's gradient back.  The schedule is named here, not in a library
schedule class, as JAX names its ``ppermute`` ring.

A hop is a broadcast in the two-rank link group of the adjacent stages
(``Mesh.prev_link`` / ``next_link``), from the sending stage: gloo
broadcasts CUDA tensors (its ``send``/``recv`` hand a device pointer to a
host transport), and NCCL, with a card a rank, too.  Every rank posts its
hops in one fixed order, so no cycle can wait on itself.  Activations
cross as float32, the dtype of the residual stream in both families (bf16
compute casts inside the layers).

The family's ends ride on the end stages: the espnet family's input layer
(none, embed, linear or conv2d*), the sqrt(d) scale and the positional
dropout run on stage 0, ``after_norm`` on the last stage; every stage
builds the positional table and the per-row pad ∧ band mask from the
lengths (every rank holds the batch's lengths) and takes its microbatch's
rows of the mask.  ``--remat`` does not apply inside stages: JAX's
``encoder_layer_module`` keeps flash and the compute dtype but not
``nn.remat``.

Dropout: each (stage, microbatch) runs its layers under a seed drawn once
a step from the explicit ``generator`` (seeded by the data index; every
stage of a pipe group draws alike) plus the stage and the microbatch, so
each (stage, microbatch, layer) draws independent masks.  JAX folds in
(stage, tick, layer); any iid masks are equally valid (JAX's docstring),
so train-mode parity runs use dropout 0.  The espnet positional table's
mask, shared by all layers in one process, is drawn from the step's seed
on every stage alike.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from transformer_transducer_tpu_torch.ops.masks import combine_masks, context_mask, padding_mask
from transformer_transducer_tpu_torch.parallel.mesh import Mesh

HOP_DTYPE = torch.float32


def encoder_layers(model) -> torch.nn.ModuleList:
    """The encoder's stacked layers of either family."""
    enc = model.encoder
    return enc.layers if hasattr(enc, "layers") else enc.encoders


def is_espnet(model) -> bool:
    return not hasattr(model.encoder, "layers")


def stage_range(n_layer: int, mesh: Mesh, stage: Optional[int] = None) -> range:
    """The layers stage ``stage`` (this rank's by default) owns."""
    per = n_layer // mesh.n_pipe
    s = mesh.pipe_rank if stage is None else stage
    return range(s * per, (s + 1) * per)


def check_split(model, n_stages: int, rows: int, n_micro: int, n_data: int = 1) -> None:
    """JAX's checks (``parallel/pipeline.py:117-120``, ``:160-175``) on a
    data rank's ``rows``: an int8 model, layers that do not divide over the
    stages, a batch of ``rows * n_data`` that does not divide into the
    microbatches, or microbatches that do not divide over the data axis."""
    if getattr(model, "quant", False):
        raise NotImplementedError(
            "pipeline parallelism is a training path; int8-quantized "
            "(inference) models are not supported")
    n_layer = len(encoder_layers(model))
    if n_layer % n_stages:
        raise ValueError(f"n_layer={n_layer} must divide over "
                         f"{n_stages} pipeline stages")
    b = rows * n_data
    if b % n_micro:
        raise ValueError(f"B={b} must divide into {n_micro} microbatches")
    if (b // n_micro) % n_data:
        raise ValueError(f"microbatch size {b // n_micro} must divide over the "
                         f"{n_data}-way data axis")


def _hop(tensor: torch.Tensor, src: int, group) -> None:
    """One hop: ``tensor`` (the sender's, or the receiver's buffer) broadcast
    from world rank ``src`` over the link ``group``."""
    dist.broadcast(tensor, src=src, group=group)


def send_next(x: torch.Tensor, mesh: Mesh) -> None:
    if x.dtype != HOP_DTYPE:
        raise TypeError(f"a pipeline hop carries {HOP_DTYPE}, got {x.dtype}")
    _hop(x.detach().contiguous(), mesh.pipe_ranks[mesh.pipe_rank], mesh.next_link)


def recv_prev(shape, device, mesh: Mesh) -> torch.Tensor:
    buf = torch.empty(shape, dtype=HOP_DTYPE, device=device)
    _hop(buf, mesh.pipe_ranks[mesh.pipe_rank - 1], mesh.prev_link)
    return buf


def send_prev(g: torch.Tensor, mesh: Mesh) -> None:
    _hop(g.contiguous(), mesh.pipe_ranks[mesh.pipe_rank], mesh.prev_link)


def recv_next(shape, device, mesh: Mesh) -> torch.Tensor:
    buf = torch.empty(shape, dtype=HOP_DTYPE, device=device)
    _hop(buf, mesh.pipe_ranks[mesh.pipe_rank + 1], mesh.next_link)
    return buf


def broadcast_from_last(x: Optional[torch.Tensor], shape, dtype, device,
                        mesh: Mesh) -> torch.Tensor:
    """The last stage's ``x`` on every rank of the pipe group."""
    if not mesh.pipelined:
        return x
    buf = x.contiguous() if mesh.last_stage else torch.empty(shape, dtype=dtype, device=device)
    dist.broadcast(buf, src=mesh.pipe_ranks[-1], group=mesh.pipe_group)
    return buf


@contextlib.contextmanager
def _seeded(seed: Optional[int], device: torch.device):
    """Draw from ``seed`` inside (nothing with None); the rank's generators
    are restored on the way out."""
    if seed is None:
        yield
        return
    devices = ([device.index if device.index is not None else torch.cuda.current_device()]
               if device.type == "cuda" else [])
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        yield


class Pipeline:
    """One pass of the encoder over this rank's stage: :meth:`forward`
    runs the microbatches through (keeping each one's input and output),
    :meth:`backward` runs them back in reverse order.

    ``generator`` (a ``torch.Generator``) seeds the stages' dropout; a
    model in train mode needs one (JAX: ``deterministic=False requires a
    dropout_rng``).  The rows are this data rank's: JAX's divisibility
    checks read the batch as ``rows * mesh.n_data``."""

    def __init__(self, model, mesh: Mesh, n_micro: int,
                 generator: Optional[torch.Generator] = None):
        self.model, self.mesh, self.n_micro = model, mesh, int(n_micro)
        self.espnet = is_espnet(model)
        if model.training and generator is None:
            raise ValueError("a pipeline in train mode requires a dropout generator")
        self.generator = generator
        self.ins: List[Optional[torch.Tensor]] = []
        self.outs: List[torch.Tensor] = []
        self.shape: Tuple[int, ...] = ()
        self.device = None

    # -- the family's pieces ------------------------------------------------
    def _frames(self, t_in: int) -> int:
        """Encoder frames of a ``t_in``-frame input (conv input layers
        shorten it)."""
        if not self.espnet:
            return t_in
        return int(self.model.encoded_lengths(torch.tensor([t_in]), t_in)[0])

    def _espnet_context(self, t: int, lengths, dtype, base: Optional[int]):
        """The per-row pad ∧ band mask (B, ·, T) and the positional table,
        its dropout drawn from the step's seed (alike on every stage)."""
        from transformer_transducer_tpu_torch.models.espnet_variant import _pos_table
        enc, model, dev = self.model.encoder, self.model, self.device
        left, right = model.encoder_left_mask, model.encoder_right_mask
        band = None
        if left >= 0 or right >= 0:
            band = context_mask(t, left if left >= 0 else t, right if right >= 0 else t,
                                device=dev)[None]
        pad = None
        if lengths is not None:
            pad = padding_mask(lengths.to(dev), t)[:, None, :]
        mask = combine_masks(band, pad)
        with _seeded(base, dev):
            pos = enc.pos_drop_emb(_pos_table(t, enc.output_size, dev).to(dtype))
        return mask, pos

    # -- the schedule -------------------------------------------------------
    def forward(self, inputs: Optional[torch.Tensor], rows: int, t_in: int,
                lengths=None, attn_mask: Optional[torch.Tensor] = None,
                band: Optional[Tuple[int, int]] = None) -> Optional[torch.Tensor]:
        """All microbatches through this stage.  ``inputs`` (stage 0's: the
        features, or the espnet input layer's input, ``rows`` of ``t_in``
        frames) may be None on the other stages; ``lengths`` (espnet: the
        input lengths, every stage) feed the pad mask; ``attn_mask`` and
        ``band`` (native) go to every layer.  Returns, on the last stage,
        the encoder output ``(rows, T, D)`` as a leaf (requiring grad when
        grad mode is on, for :meth:`backward`); None on the others."""
        mesh, model = self.mesh, self.model
        check_split(model, mesh.n_pipe, rows, self.n_micro, mesh.n_data)
        self.device = (inputs.device if inputs is not None
                       else next(p.device for p in model.parameters()))
        layers = encoder_layers(model)
        mine = [layers[i] for i in stage_range(len(layers), mesh)]
        bm, t = rows // self.n_micro, self._frames(t_in)
        d = model.encoder.output_size if self.espnet else inputs_width(model)
        self.shape = (bm, t, d)
        grad = torch.is_grad_enabled()
        base = None
        if model.training:
            base = int(torch.randint(0, 2 ** 62, (1,), generator=self.generator))
        mask = pos = None
        if self.espnet:
            if lengths is not None:
                lengths = model.encoded_lengths(torch.as_tensor(lengths), t_in)
            mask, pos = self._espnet_context(t, lengths, HOP_DTYPE, base)
        # a per-row mask rides the microbatch split; a band alone is shared
        row_mask = mask is not None and mask.shape[0] == rows
        self.ins, self.outs = [], []
        for m in range(self.n_micro):
            seed = None if base is None else base + 1 + mesh.pipe_rank * self.n_micro + m
            with _seeded(seed, self.device):
                if mesh.first_stage:
                    h = self._first(inputs[m * bm:(m + 1) * bm])
                    h_in = None
                else:
                    h_in = recv_prev(self.shape, self.device, mesh)
                    h = h_in.requires_grad_(grad)
                m_mask = mask[m * bm:(m + 1) * bm] if row_mask else mask
                for layer in mine:
                    h = layer(h, pos, m_mask) if self.espnet else layer(h, attn_mask, band)
                if mesh.last_stage and self.espnet:
                    h = model.encoder.after_norm(h)
            if not mesh.last_stage:
                send_next(h, mesh)
            self.ins.append(h_in)
            self.outs.append(h)
        if not mesh.last_stage:
            return None
        enc = torch.cat([o.detach() for o in self.outs])
        return enc.requires_grad_(grad)

    def _first(self, x: torch.Tensor) -> torch.Tensor:
        """Stage 0's input: the features (native), or the espnet input
        layer, the sqrt(d) scale and the positional dropout."""
        if not self.espnet:
            return x
        enc = self.model.encoder
        h, _ = enc.input_transform(x, None)
        return enc.pos_drop(h * math.sqrt(enc.output_size))

    def backward(self, grad: Optional[torch.Tensor] = None) -> None:
        """The microbatches back in reverse order: on the last stage from
        ``grad`` (the gradient of :meth:`forward`'s output), on the others
        from the next stage's hop; each stage's input gradient goes back
        to the stage before it.  The parameters' ``.grad`` sum the
        microbatches' gradients in that order."""
        mesh = self.mesh
        bm = self.shape[0]
        for m in reversed(range(self.n_micro)):
            g = (grad[m * bm:(m + 1) * bm] if mesh.last_stage
                 else recv_next(self.shape, self.device, mesh))
            torch.autograd.backward(self.outs[m], g)
            if not mesh.first_stage:
                h_in = self.ins[m]
                send_prev(h_in.grad if h_in.grad is not None else torch.zeros_like(h_in), mesh)
        self.ins, self.outs = [], []


def inputs_width(model) -> int:
    """d_model of the native encoder (its features' width)."""
    layer = model.encoder.layers[0]
    return layer.MultiHeadAttention.pos_ff.CoreNet[0].in_features


def encode_pipelined(model, x: Optional[torch.Tensor], mesh: Mesh, n_micro: int,
                     attn_mask: Optional[torch.Tensor] = None,
                     band: Optional[Tuple[int, int]] = None,
                     generator: Optional[torch.Generator] = None,
                     rows: Optional[int] = None, t_in: Optional[int] = None) -> torch.Tensor:
    """Pipelined native encoder forward, without gradients: ``(B, T, D)``
    on every rank of the pipe group, equal to ``model.encode(x,
    attn_mask)`` (or the banded encoder under ``band``) of a whole model
    (JAX ``encode_pipelined``).  Stages other than 0 may pass ``x=None``
    with ``rows`` and ``t_in``."""
    rows = x.shape[0] if rows is None else rows
    t_in = x.shape[1] if t_in is None else t_in
    with torch.no_grad():
        pipe = Pipeline(model, mesh, n_micro, generator)
        enc = pipe.forward(x, rows, t_in, attn_mask=attn_mask, band=band)
    return broadcast_from_last(enc, (rows, *pipe.shape[1:]), HOP_DTYPE, pipe.device, mesh)


def encode_pipelined_espnet(model, xs: Optional[torch.Tensor], lengths, mesh: Mesh,
                            n_micro: int, generator: Optional[torch.Generator] = None,
                            rows: Optional[int] = None, t_in: Optional[int] = None):
    """Pipelined espnet encoder forward, without gradients: ``(enc (B, T',
    D), out_lengths)`` on every rank of the pipe group, equal to
    ``model.encode`` and ``model.encoded_lengths`` (JAX
    ``encode_pipelined_espnet``)."""
    rows = xs.shape[0] if rows is None else rows
    t_in = xs.shape[1] if t_in is None else t_in
    with torch.no_grad():
        pipe = Pipeline(model, mesh, n_micro, generator)
        enc = pipe.forward(xs, rows, t_in, lengths=lengths)
    out = broadcast_from_last(enc, (rows, *pipe.shape[1:]), HOP_DTYPE, pipe.device, mesh)
    lens = None if lengths is None else model.encoded_lengths(
        torch.as_tensor(lengths, device=out.device), t_in)
    return out, lens


def encode_for_decoding(model, inputs: Optional[torch.Tensor], t_len, mesh: Mesh,
                        n_micro: int, rows: Optional[int] = None,
                        t_in: Optional[int] = None):
    """``(enc, t_len)`` for the decoders through the pipeline, on every
    rank of the pipe group, as ``model.encode_for_decoding(inputs,
    t_len)`` gives them (full context; an espnet encoder under its own
    band, with the lengths)."""
    if is_espnet(model):
        return encode_pipelined_espnet(model, inputs, t_len, mesh, n_micro, rows=rows,
                                       t_in=t_in)
    return encode_pipelined(model, inputs, mesh, n_micro, rows=rows, t_in=t_in), t_len
