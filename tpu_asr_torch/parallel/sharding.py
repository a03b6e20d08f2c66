"""Parameter sharding rules: tensor parallelism over the mesh's 'model'
axis (port of tpu_asr/parallel/sharding.py).

The reference's rules (`_spec_for`), by parameter:
  attention q/k/v kernel  [d_model, H, dh]  -> split H
  attention out_proj      [H, dh, d_model]  -> split H (its input heads)
  FFN w_1 kernel          [d_model, d_inner] -> split d_inner (outputs)
  FFN w_2 kernel          [d_inner, d_model] -> split d_inner (inputs)
everything else replicated. In the port's [out, in] weights that is
dim 0 of q/k/v_proj.weight and w_1.weight and dim 1 of out_proj.weight
and w_2.weight. The modules that own such weights declare them
(`TP_SHARDED`, name -> dim; `TP_SLICED`, the replicated ones read by
block, dim 0), so the rules follow the module types
(MultiHeadAttention, RelPosMultiHeadAttention, PositionwiseFeedForward)
and not their paths.

GSPMD derives the collectives from these layouts; the port writes them
down, Megatron-style. A module on its local heads (or local d_inner)
takes its input through `copy_to_model` (identity forward, the input
gradient summed over the axis backward) and returns through
`row_parallel`, whose partial product is summed over the axis forward
(identity backward) before the bias, which is added once. Replicated
parameters that a module reads through its local slice (`TP_SLICED`:
the q/k/v and w_1 biases, the conformer's pos_proj weight and u/v
biases) get only their slice's gradient on each rank; the train step
sums those over the axis (`sliced_params`). With n_model == 1 nothing
changes: plain data parallelism.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_asr_torch.parallel.mesh import Axis, Mesh


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Entry of a tensor-parallel region: x as it is; its gradient is the
    sum of the ranks' gradients."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Exit of a tensor-parallel region: the sum of the ranks' partial x;
    the gradient passes to each rank as it is."""
    return _ReduceFromModel.apply(x, axis)


def local_part(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's contiguous block of `t` along `dim` (a view)."""
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"{n} does not split over {axis.size} ranks")
    n //= axis.size
    return t.narrow(dim, axis.index * n, n)


def column_parallel(dense, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A Dense whose weight holds this rank's output rows and whose bias
    is whole (replicated): x @ W_local^T + b_local, in the compute dtype."""
    dt = dense.compute_dtype
    b = None if dense.bias is None else local_part(dense.bias, 0, axis)
    return F.linear(x.to(dt), dense.weight.to(dt),
                    None if b is None else b.to(dt))


class _PartialProduct(torch.autograd.Function):
    """x @ w^T kept in float32: the sums a GEMM in the compute dtype makes
    before it rounds them, so that the ranks' partial products are added
    before the one rounding a single process's GEMM makes. The backward
    is the compute dtype's, as F.linear's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x.float(), w.float().t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.reshape(-1, g.shape[-1]).t() @ x.reshape(
            -1, x.shape[-1])


def row_parallel(dense, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A Dense whose weight holds this rank's input columns: the partial
    products, unrounded, summed over the axis in float32, then the bias
    (in the compute dtype, as Dense adds it) once, then one rounding to
    the compute dtype."""
    dt = dense.compute_dtype
    partial = _PartialProduct.apply(x.to(dt), dense.weight.to(dt))
    out = reduce_from_model(partial, axis)
    if dense.bias is not None:
        out = out + dense.bias.to(dt).float()
    return out.to(dt)


def _tp_modules(model):
    for prefix, m in model.named_modules():
        if getattr(type(m), "TP_SHARDED", None):
            yield (prefix + "." if prefix else ""), m


def param_specs(model) -> dict[str, int | None]:
    """Every parameter's name -> the dim split over 'model', or None
    (replicated)."""
    specs = {name: None for name, _ in model.named_parameters()}
    for prefix, m in _tp_modules(model):
        for name, dim in type(m).TP_SHARDED.items():
            specs[prefix + name] = dim
    return specs


def sliced_params(model) -> set[str]:
    """Replicated parameters that tensor-parallel modules read through
    their local block of heads or columns (their gradients are partial on
    each rank)."""
    return {prefix + name for prefix, m in _tp_modules(model)
            for name in type(m).TP_SLICED}


def shard_params(model, mesh: Mesh) -> dict[str, int | None]:
    """Keep, in place, this rank's block of every sharded weight, and put
    the tensor-parallel modules on the mesh's model axis (the Parameter
    objects stay, so an optimizer that has taken no step may hold them
    already). -> param_specs(model). With n_model == 1 the model is left
    as it is."""
    specs = param_specs(model)
    if mesh.n_model == 1:
        return specs
    axis = mesh.model
    params = dict(model.named_parameters())
    with torch.no_grad():
        for prefix, m in _tp_modules(model):
            for name, dim in type(m).TP_SHARDED.items():
                p = params[prefix + name]
                p.data = local_part(p.data, dim, axis).clone()
            m.tp = axis
    return specs


def gather_params(model, mesh: Mesh | None,
                  specs: dict[str, int | None] | None = None) -> dict:
    """The full (unsharded) state_dict of a model that shard_params cut:
    every rank of the model axis takes part and gets the whole."""
    state = model.state_dict()
    if mesh is None or mesh.n_model == 1:
        return state
    specs = param_specs(model) if specs is None else specs
    return {k: (v if specs.get(k) is None else
                mesh.model.all_gather(v, specs[k]))
            for k, v in state.items()}


def shard_tensor(t: torch.Tensor, dim: int | None,
                 mesh: Mesh | None) -> torch.Tensor:
    """A full tensor -> this rank's block along `dim` (None: whole)."""
    if mesh is None or mesh.n_model == 1 or dim is None:
        return t
    return local_part(t, dim, mesh.model).clone()
