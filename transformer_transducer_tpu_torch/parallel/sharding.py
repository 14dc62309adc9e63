"""Parameter shardings on the ``(data, model, pipe)`` grid (port of
``parallel/sharding.py``).

**Tensor parallelism** (``param_specs``, :func:`shard_model`): JAX's rules
by the leaf's path in the JAX tree, which :func:`jax_paths` gives for each
port parameter (the names that ``utils/convert.py::from_jax_params`` maps
the other way).  Column-parallel projections (``qkv``, ``linear_q/k/v/pos``,
``fc1``, ``w_1``, ``forward_layer``, ``lin_enc``, ``lin_dec``, and their
biases) keep this rank's output columns; row-parallel ones (``attn/out``,
``linear_out``, ``fc2``, ``w_2``, ``project_layer``, ``lin_out``) their
input rows, the bias whole; the position tables (``r_emb``, ``r_bias``,
``r_w_bias``, ``pos_bias_u/v``) this rank's heads.  Everything else is whole
on every model rank.  ``parallel/tensor.py`` names the collectives that
GSPMD would insert.  One standing difference: JAX's ``P(None, 'model')``
cuts the fused ``qkv`` kernel ``[q | k | v]`` into contiguous pieces, which
GSPMD reshards; the port takes head-aligned slices instead (rank m holds
``[q_m | k_m | v_m]``, heads ``m·H/N … (m+1)·H/N``), so the attention's
view and the kernels' row stride work unchanged at ``H/N`` heads.  The
sharded dimension is JAX's; only ``qkv``'s element set differs.

**Pipeline parallelism** (:func:`pipe_model`): a stage keeps its own
encoder layers (``parallel/pipeline.py::stage_range``) and frees the
others' storage (their parameters become empty tensors, so the model's
parameter list and names stay whole-model aligned); every other leaf (the
label encoder, the joint, the espnet input layer and ``after_norm``) is
held on every stage.  JAX stacks the layers into one ``(n_layer, ...)``
tree sharded on ``pipe``; the port keeps the canonical per-layer leaves,
which is the layout JAX's ``_to_canonical`` writes to checkpoints, so
:func:`gathered_state_dict` returns the whole model in that layout and
:func:`narrow_state_dict` reads a whole checkpoint into a stage.

**ZeRO-1** (:func:`zero_param_shardings`): parameters and gradients stay
whole on every data rank; each moment (the SGD trace, Adam's mu and nu,
Adadelta's accumulators) is split over the data ranks on one dimension of
its parameter, the ZeRO stage-1 partition (Rajbhandari et al.,
arXiv:1910.02054).  The dimension is the JAX rule's: the largest dimension
that divides by ``n_data`` and is not the model axis's, the first of equals,
read in the JAX layout of the leaf, so a port slice holds the same elements
as the JAX device's shard (a torch ``Linear.weight`` is the transpose of a
flax kernel, a ``Conv2d`` weight flax's (KH, KW, I, O) permuted to (O, I,
KH, KW)).  A leaf with no such dimension stays whole on every data rank.
On the ``(data, pipe)`` grid JAX's stacked leaf has ``pipe`` on its layer
dimension, so its data dimension is the largest divisible one of the
layer's own: the rule on the port's per-layer leaf.  A stage's freed
leaves have no moments.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from transformer_transducer_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from transformer_transducer_tpu_torch.parallel.pipeline import encoder_layers, stage_range


@dataclasses.dataclass(frozen=True)
class ZeroSlice:
    """This rank's part of a leaf: ``size`` rows from ``start`` on ``dim``."""

    dim: int
    start: int
    size: int

    def of(self, x: torch.Tensor) -> torch.Tensor:
        return x.narrow(self.dim, self.start, self.size)


def jax_dims(module: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """For each dimension of the JAX leaf, the port dimension that holds it."""
    if name == "weight" and isinstance(module, nn.Linear):
        return (1, 0)
    if name == "weight" and isinstance(module, nn.Conv2d):
        return (2, 3, 1, 0)
    return tuple(range(ndim))


# JAX's rules (parallel/sharding.py: _COL_KERNELS, _ROW_KERNELS, _spec_for)
_COL_KERNELS = ("linear_q", "linear_k", "linear_v", "linear_pos",
                "fc1", "w_1", "forward_layer", "lin_enc", "lin_dec")
_ROW_KERNELS = ("attn/out", "linear_out", "fc2", "w_2", "project_layer",
                "lin_out")


def spec_for(path: str, ndim: int) -> Tuple:
    """JAX's ``_spec_for`` on a leaf's path in the JAX tree (``/``-joined):
    its partition spec, ``MODEL_AXIS`` on the sharded dimension, as a
    tuple (``()``: whole)."""
    if "qkv" in path and path.endswith("kernel"):
        return (None, MODEL_AXIS)
    for mod in _COL_KERNELS:
        if path.endswith(f"{mod}/kernel"):
            return (None, MODEL_AXIS)
        if path.endswith(f"{mod}/bias"):
            return (MODEL_AXIS,)
    for mod in _ROW_KERNELS:
        # full module-path suffixes: the conv subsampling's "out" Dense
        # stays whole
        if path.endswith(f"{mod}/kernel"):
            return (MODEL_AXIS, None)
    if path.endswith("r_emb"):
        return (None, MODEL_AXIS, None)
    if path.endswith("r_bias") and ndim == 2:
        return (None, MODEL_AXIS)
    if path.endswith(("r_w_bias", "pos_bias_u", "pos_bias_v")):
        return (MODEL_AXIS, None)
    return ()


# module paths of the port -> the JAX tree's (utils/convert.py maps them the
# other way); applied in order to the dotted module path
_MODULE_RENAMES = (
    (r"(^|\.)(?:layers|encoders)\.(\d+)(?=\.|$)", r"\1layer_\2"),
    (r"MultiHeadAttention\.dec_attn\.qkv_net$", "attn.qkv"),
    (r"MultiHeadAttention\.dec_attn\.o_net$", "attn.out"),
    (r"MultiHeadAttention\.dec_attn\.layer_norm$", "attn.ln"),
    (r"MultiHeadAttention\.pos_ff\.layer_norm$", "ff.ln"),
    (r"MultiHeadAttention\.pos_ff\.CoreNet\.0$", "ff.fc1"),
    (r"MultiHeadAttention\.pos_ff\.CoreNet\.3$", "ff.fc2"),
    (r"\.dec_embedding$", ".embedding"),
    (r"\.embed\.conv\.(\d+)$", lambda m: f".subsample.conv_{int(m.group(1)) // 2}"),
    (r"\.embed\.out\.0$", ".subsample.out"),
    (r"\.embed\.1$", ".input_norm"),
)


def _jax_module_path(name: str, module: nn.Module) -> str:
    for pattern, repl in _MODULE_RENAMES:
        name = re.sub(pattern, repl, name)
    if name.endswith(".embed.0"):     # an espnet input layer: embedding or Linear
        name = name[:-len(".0")] if isinstance(module, nn.Embedding) \
            else name[:-len(".embed.0")] + ".input_proj"
    return name.replace(".", "/")


def _jax_leaf(module: nn.Module, name: str) -> str:
    if name != "weight":
        return name
    if isinstance(module, nn.LayerNorm):
        return "scale"
    if isinstance(module, nn.Embedding):
        return "embedding"
    return "kernel"


def jax_paths(model: nn.Module) -> Dict[str, str]:
    """Each parameter's path in the JAX parameter tree, by its port name."""
    out = {}
    for mod_name, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            key = f"{mod_name}.{name}" if mod_name else name
            out[key] = f"{_jax_module_path(mod_name, module)}/{_jax_leaf(module, name)}"
    return out


def param_specs(model: nn.Module) -> Dict[str, Tuple]:
    """JAX's ``param_specs`` of a port model: each parameter's partition
    spec over its JAX dimensions, by its port name."""
    paths = jax_paths(model)
    return {name: spec_for(paths[name], p.dim()) for name, p in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class TPSlice(ZeroSlice):
    """This model rank's part of a leaf: ``size`` from ``start`` on ``dim``
    of each of its ``blocks`` equal blocks (3 for the fused ``[q | k | v]``
    projection, so the slice is head-aligned; 1 otherwise)."""

    blocks: int = 1

    def of(self, x: torch.Tensor) -> torch.Tensor:
        if self.blocks == 1:
            return super().of(x)
        return (x.unflatten(self.dim, (self.blocks, -1))
                .narrow(self.dim + 1, self.start, self.size).flatten(self.dim, self.dim + 1))

    def put(self, whole: torch.Tensor, part: torch.Tensor) -> None:
        """Write ``part`` (this rank's slice) into ``whole`` (a contiguous
        tensor of the whole leaf's shape)."""
        if self.blocks == 1:
            whole.narrow(self.dim, self.start, self.size).copy_(part)
        else:
            whole.unflatten(self.dim, (self.blocks, -1)).narrow(
                self.dim + 1, self.start, self.size).copy_(
                part.unflatten(self.dim, (self.blocks, -1)))


def _port_dims(model: nn.Module) -> Dict[int, Tuple[int, ...]]:
    dims = {}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            dims.setdefault(id(p), jax_dims(module, name, p.dim()))
    return dims


_HEAD_TABLES = ("r_emb", "r_bias", "r_w_bias", "pos_bias_u", "pos_bias_v")


def tp_slices(model: nn.Module, mesh: Mesh) -> List[Optional[TPSlice]]:
    """This model rank's slice of each of ``model.parameters()`` of a whole
    model (None: whole on every model rank).  Raises ``ValueError`` where
    a sharded dimension (heads, ``d_inner``, the joint's inner width) does
    not divide over the model ranks."""
    specs, dims = param_specs(model), _port_dims(model)
    paths = jax_paths(model)
    by_id = {id(p): name for name, p in model.named_parameters()}
    out: List[Optional[TPSlice]] = []
    for p in model.parameters():
        name = by_id[id(p)]
        spec = specs[name]
        if mesh.n_model <= 1 or MODEL_AXIS not in spec:
            out.append(None)
            continue
        dim = dims[id(p)][spec.index(MODEL_AXIS)]
        blocks = 3 if "qkv" in paths[name] else 1
        width = p.shape[dim] // blocks
        if width % mesh.n_model:
            unit = "heads" if paths[name].endswith(_HEAD_TABLES) else "features"
            raise ValueError(
                f"tensor parallelism over {mesh.n_model} model ranks: {name} "
                f"({paths[name]}) has {width} {unit} on its sharded dimension, "
                "which do not divide over them")
        size = width // mesh.n_model
        out.append(TPSlice(dim, mesh.model_rank * size, size, blocks))
    return out


def _tp_modules(model: nn.Module):
    """The modules that name collectives under tensor parallelism (their
    class declares ``tp``)."""
    return [m for m in model.modules() if hasattr(type(m), "tp")]


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Narrow a whole ``model`` to this model rank's slices in place, and
    give its modules the mesh, whose model group their collectives run
    over.  A mesh of one model rank leaves it whole."""
    if not mesh.tensor_parallel:
        return model
    slices = tp_slices(model, mesh)          # raises before anything changes
    with torch.no_grad():
        for p, piece in zip(model.parameters(), slices):
            if piece is not None:
                p.data = piece.of(p.data).contiguous().clone()
    for m in _tp_modules(model):
        m.tp = mesh
    model.tp, model.tp_slices = mesh, slices
    return model


def whole_leaf(part: torch.Tensor, piece: TPSlice, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every model rank's ``part``: each rank writes its
    part into zeros and an all-reduce sums them (exact, but for the sign of
    a zero; gloo has no all-gather of CUDA tensors)."""
    shape = list(part.shape)
    shape[piece.dim] *= mesh.n_model
    whole = part.new_zeros(shape)
    piece.put(whole, part)
    dist.all_reduce(whole, group=mesh.model_group)
    return whole


def sharded(model: nn.Module) -> List[Optional[TPSlice]]:
    """The slices :func:`shard_model` took, one a parameter (all None for a
    whole model)."""
    slices = getattr(model, "tp_slices", None)
    return slices if slices is not None else [None] * len(list(model.parameters()))


def tp_plan(model: nn.Module) -> Optional[Tuple[Mesh, List[Optional[TPSlice]]]]:
    """``(mesh, slices)`` of a sharded model, as the optimizer takes them
    (``training/optim.py``); None for a whole one."""
    return None if getattr(model, "tp", None) is None else (model.tp, model.tp_slices)


def pipe_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this stage's encoder layers of a whole ``model`` in place and
    free the other stages' (their parameters become empty tensors);
    ``model.pipe`` is the mesh and ``model.pipe_shapes`` each parameter's
    whole shape where it is a stage's (None where every stage holds it).
    A mesh of one stage leaves the model whole."""
    if not mesh.pipelined:
        return model
    layers = encoder_layers(model)
    if len(layers) % mesh.n_pipe:
        raise ValueError(f"n_layer={len(layers)} must divide over "
                         f"{mesh.n_pipe} pipeline stages")
    mine = set(stage_range(len(layers), mesh))
    stage_of = {}
    for i, layer in enumerate(layers):
        for p in layer.parameters():
            stage_of[id(p)] = i in mine
    shapes = []
    with torch.no_grad():
        for p in model.parameters():
            own = stage_of.get(id(p))
            shapes.append(None if own is None else p.shape)
            if own is False:
                p.data = p.data.new_empty(0)
    model.pipe, model.pipe_shapes = mesh, shapes
    return model


def pipe_plan(model: nn.Module) -> Optional[Tuple[Mesh, List[Optional[torch.Size]]]]:
    """``(mesh, whole shapes)`` of a pipe-split model, as the optimizer
    takes them (``training/optim.py``); None for a whole one."""
    return None if getattr(model, "pipe", None) is None else (model.pipe, model.pipe_shapes)


def stage_leaf(part: torch.Tensor, shape, mesh: Mesh) -> torch.Tensor:
    """A stage's leaf whole on every rank of the pipe group: its stage
    writes it into zeros and an all-reduce sums them (exact, but for the
    sign of a zero)."""
    whole = part.new_zeros(shape)
    if part.numel():
        whole.copy_(part)
    dist.all_reduce(whole, group=mesh.pipe_group)
    return whole


def gathered_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole model's ``state_dict`` from a sharded or pipe-split one
    (a collective: every rank of the model or pipe group calls it); the
    model stays as it is."""
    state = model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    for name, piece in zip(names, sharded(model)):
        if piece is not None:
            state[name] = whole_leaf(state[name], piece, model.tp)
    plan = pipe_plan(model)
    if plan is not None:
        for name, shape in zip(names, plan[1]):
            if shape is not None:
                state[name] = stage_leaf(state[name], shape, plan[0])
    return state


def gather_model(model: nn.Module) -> nn.Module:
    """The inverse of :func:`shard_model`, in place: every parameter whole
    again and no collective left in the forward (a collective)."""
    slices = getattr(model, "tp_slices", None)
    if slices is None:
        return model
    with torch.no_grad():
        for p, piece in zip(model.parameters(), slices):
            if piece is not None:
                p.data = whole_leaf(p.data, piece, model.tp)
    for m in _tp_modules(model):
        m.tp = None
    model.tp, model.tp_slices = None, None
    return model


def narrow_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor],
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """A whole ``state`` (keys under ``prefix`` of ``model``'s names)
    narrowed to the slices of a sharded ``model`` (empty where a
    pipe-split ``model``'s stage does not hold the leaf), to load into it."""
    params = dict(model.named_parameters())
    pieces = {n: s for n, s in zip(params, sharded(model)) if s is not None}
    out = {}
    for k, v in state.items():
        name = prefix + k
        if name in pieces:
            v = pieces[name].of(v)
        elif name in params and params[name].numel() == 0 and v.numel():
            v = v.new_empty(0)
        out[k] = v
    return out


def zero_dim(shape: Sequence[int], n_data: int,
             taken: Optional[int] = None) -> Optional[int]:
    """JAX's rule on a leaf's shape: its largest dimension that divides by
    ``n_data`` (the first of equals) other than ``taken`` (the model
    axis's), or None (a scalar, no divisible dimension, or one rank)."""
    free = [d for d, n in enumerate(shape) if n % n_data == 0 and d != taken]
    if n_data <= 1 or not shape or not free:
        return None
    return max(free, key=lambda d: shape[d])


def zero_param_shardings(model: nn.Module, mesh: Mesh) -> List[Optional[ZeroSlice]]:
    """This data rank's slice of each of ``model.parameters()`` (None:
    whole), of this model rank's part of a sharded model or this stage's
    leaves of a pipe-split one."""
    dims = _port_dims(model)
    out: List[Optional[ZeroSlice]] = []
    for p, piece in zip(model.parameters(), sharded(model)):
        if p.numel() == 0:          # another stage's leaf
            out.append(None)
            continue
        to_port = dims[id(p)]
        taken = None if piece is None else to_port.index(piece.dim)
        d = zero_dim([p.shape[i] for i in to_port], mesh.n_data, taken)
        if d is None:
            out.append(None)
            continue
        size = p.shape[to_port[d]] // mesh.n_data
        out.append(ZeroSlice(to_port[d], mesh.data_rank * size, size))
    return out
