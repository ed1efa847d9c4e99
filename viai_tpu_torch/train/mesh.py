"""Device mesh and data/model parallelism on torch.distributed.

Port of `viai_tpu/train/mesh.py`. The JAX package runs one controller
over many devices; the port runs one process per card (SPMD: the same
program on every rank, e.g. under `python -m torch.distributed.run`).
A `Mesh` holds the world's ranks as a (data, model) grid with the
process group of each axis. Rank r sits at data index r // n_model and
model index r % n_model.

* The data axis splits the global batch by rows: data index d holds
  rows [d·b, (d+1)·b) of a global batch of n_data·b rows. The train
  steps average gradients and reported losses over the data group.
  Where JAX's global-batch semantics come for free, the port has
  explicit code: batch-norm moments are the data group's means
  (`sync_batch_stats`), weighted losses divide by the data group's
  mean weight sum (`data_mean`), the ImagePool is updated from the
  fakes of every rank (`all_gather_rows`), and the step's draws are
  made for the global batch from the same generator on every rank and
  then sliced (`local_rows`). Every rank then computes the single-device
  step's math on its rows.
* The model axis splits the optimizer (`shard_params`): each model rank
  keeps its slice of the sharded parameters' optimizer state, updates
  that slice, and the full parameters are all-gathered over the model
  group after the step (ZeRO-style). A parameter is sharded on the axis
  the JAX package shards, flax's LAST axis, when that axis divides by
  the model axis with at least `min_shard` entries a rank.

Without a process group `make_mesh` gives the trivial 1×1 mesh, and
every function here is the identity on it. Collectives run only over
axes of more than one rank.
"""

from __future__ import annotations

import dataclasses
import os
import typing as tp

import torch
import torch.distributed as dist
from torch import nn

from .._device import resolve_device
from .schedules import optimizer_step


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, model) grid."""

    shape: dict[str, int]        # {"data": n_data, "model": n_model}
    device: torch.device         # this rank's device
    data_index: int
    model_index: int
    data_group: tp.Any = None    # ProcessGroup of the data axis
    model_group: tp.Any = None   # ProcessGroup of the model axis
    device_mesh: tp.Any = None   # the DeviceMesh; None for the 1x1 mesh

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None


def _rank_device(devices) -> torch.device:
    """This rank's device: `devices` (a device, or a sequence holding
    one), by default the card; under a group, a CUDA device is the card
    maybe_initialize_distributed made current for this rank."""
    if isinstance(devices, (list, tuple)):
        if len(devices) != 1:
            raise ValueError("one process drives one device; pass one")
        devices = devices[0]
    if devices is None:
        devices = ("cpu" if dist.is_initialized()
                   and dist.get_backend() == "gloo" else "cuda")
    dev = resolve_device(devices)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_data: int | None = None, devices=None,
              n_model: int = 1) -> Mesh:
    """Mesh over the world's ranks as (data, model); n_data defaults to
    world // n_model and n_data·n_model must be the world's size. With
    no process group, the 1x1 mesh on `devices` (default: the card)."""
    dev = _rank_device(devices)
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise ValueError(
                f"a {n_data}x{n_model} mesh needs a process group of "
                f"{(n_data or 1) * n_model} ranks "
                "(maybe_initialize_distributed); none is initialized")
        return Mesh({"data": 1, "model": 1}, dev, 0, 0)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh does not cover the "
                         f"world's {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (n_data, n_model),
                          mesh_dim_names=("data", "model"))
    return Mesh({"data": n_data, "model": n_model}, dev,
                dm.get_local_rank("data"), dm.get_local_rank("model"),
                dm.get_group("data"), dm.get_group("model"), dm)


# ---------------------------------------------------------------------------
# The data axis
# ---------------------------------------------------------------------------

def local_rows(x: torch.Tensor, mesh: Mesh | None, dim: int = 0
               ) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (along `dim`)."""
    if mesh is None or mesh.shape["data"] == 1:
        return x
    n = mesh.shape["data"]
    if x.shape[dim] % n:
        raise ValueError(f"batch of {x.shape[dim]} rows does not divide "
                         f"over the data axis ({n} ranks)")
    return x.chunk(n, dim)[mesh.data_index]


def global_rows(local: int, mesh: Mesh | None) -> int:
    """The global batch's rows for `local` rows a rank."""
    return local * (1 if mesh is None else mesh.shape["data"])


def all_gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's rows of x, in data order: the global batch (no
    gradient flows back)."""
    if mesh is None or mesh.shape["data"] == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts)


class _DataMean(torch.autograd.Function):
    """The data group's mean; its backward is the data group's mean of
    the gradient (each rank's loss is a 1/n share of the global one)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        g = g.clone().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def data_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Mean of x over the data group (x itself on one data rank),
    differentiable: the batch-norm moments and the losses' weight sums
    of the global batch are the data group's means of the ranks' ones
    (every rank holds as many rows)."""
    if mesh is None or mesh.shape["data"] == 1:
        return x
    return _DataMean.apply(x, mesh.data_group, mesh.shape["data"])


def average_gradients(params: tp.Iterable[torch.Tensor],
                      mesh: Mesh | None):
    """Each parameter's .grad ← its mean over the data group, in one
    flat all-reduce."""
    if mesh is None or mesh.shape["data"] == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.shape["data"]
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def average_metrics(metrics: dict[str, torch.Tensor], mesh: Mesh | None
                    ) -> dict[str, torch.Tensor]:
    """0-dim metrics → their data-group means, in one all-reduce."""
    if mesh is None or mesh.shape["data"] == 1 or not metrics:
        return metrics
    vals = data_mean(torch.stack([v.detach().float()
                                  for v in metrics.values()]), mesh)
    return dict(zip(metrics, vals.unbind(0)))


def sync_batch_stats(module: nn.Module | None, mesh: Mesh | None):
    """Make the module's batch norms take their moments over the data
    group, i.e. over the global batch, as the JAX package's do."""
    if module is None or mesh is None or mesh.shape["data"] == 1:
        return
    from ..nn.generator import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.stats_mean = lambda x, mesh=mesh: data_mean(x, mesh)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The batch axis split over the mesh's data axis, the rest
    replicated: `local(x)` is this rank's rows of a global batch, on
    this rank's device."""

    mesh: Mesh

    def local(self, x) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.as_tensor(x)
        return local_rows(t, self.mesh).to(self.mesh.device)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Leading (batch) axis sharded over 'data', rest replicated."""
    return BatchSharding(mesh)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(batch, mesh: Mesh):
    """A host batch (a tensor, array, or dict/list of them) of the global
    batch → this rank's rows on its device."""
    return _tree_map(batch_sharding(mesh).local, batch)


def global_batch_from_local(local_batch, mesh: Mesh):
    """Each rank's own rows (a tensor, array, or dict/list of them) →
    on its device, after checking that every rank holds as many rows:
    the ranks' rows in data order make the global batch."""
    out = _tree_map(lambda x: (x if torch.is_tensor(x)
                               else torch.as_tensor(x)).to(mesh.device),
                    local_batch)
    if mesh.distributed:
        rows = []
        _tree_map(lambda x: rows.append(x.shape[0]), out)
        mine = torch.tensor(rows, device=mesh.device)
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        if any(not torch.equal(e, mine) for e in every):
            raise ValueError(f"ranks hold different numbers of rows: "
                             f"{[e.tolist() for e in every]}")
    return out


# ---------------------------------------------------------------------------
# Placement of parameters and optimizer state
# ---------------------------------------------------------------------------

def _broadcast(t: torch.Tensor):
    if dist.is_initialized() and dist.get_world_size() > 1:
        with torch.no_grad():
            dist.broadcast(t.data, src=0)


def _is_optimizer(x) -> bool:
    return isinstance(x, (torch.optim.Optimizer, ShardedOptimizer))


def replicate(tree, mesh: Mesh):
    """Every rank's copy of `tree` (modules, optimizers, tensors, and
    dicts/lists of them) ← rank 0's: a broadcast over the world.
    Modules and optimizers change in place; tensors are moved to the
    mesh's device first. Returns the tree."""
    def place(x):
        if isinstance(x, nn.Module):
            for t in [*x.parameters(), *x.buffers()]:
                _broadcast(t)
        elif _is_optimizer(x):
            for st in x.state.values():
                for v in st.values():
                    if torch.is_tensor(v) and v.dim():
                        _broadcast(v)
        elif torch.is_tensor(x):
            x = x.to(mesh.device)
            _broadcast(x)
        return x

    return _tree_map(place, tree)


def shard_plan(module: nn.Module, n_model: int, min_shard: int = 8
               ) -> dict[str, int | None]:
    """Parameter name → the dim `shard_params` splits over `n_model`
    ranks, None where it replicates. The policy is the JAX package's on
    the flax shape: its LAST axis when that divides by n_model with at
    least `min_shard` entries a rank. Through the weight bridge's
    layouts (nn/generator.py `conv_weight_from_hwio`,
    `deconv_weight_from_hwio`), flax's last axis is torch's dim 0 of a
    Conv2d/Conv3d/Linear weight (flax (*spatial, cin, cout) and
    (in, out)), of a bias and of a norm's scale, and dim 1 of a
    ConvTranspose2d weight (flax (kh, kw, cin, cout))."""
    plan = {}
    for name, mod in module.named_modules():
        pre = f"{name}." if name else ""
        for pname, p in mod.named_parameters(recurse=False):
            dim = (1 if isinstance(mod, nn.ConvTranspose2d)
                   and pname == "weight" else 0)
            size = p.shape[dim] if p.dim() else 0
            plan[pre + pname] = (dim if p.dim() and size % n_model == 0
                                 and size // n_model >= min_shard else None)
    return plan


class ShardedOptimizer:
    """An optimizer whose state and update are split over the mesh's
    model axis (ZeRO-style). Each sharded parameter is replaced in the
    optimizer by a leaf holding this model rank's slice; `step` hands
    the slice its part of the full gradient (already averaged over the
    data group), runs the optimizer on the slices and the replicated
    parameters, and all-gathers the slices into the full parameters
    over the model group. The math is the replicated step's: each slice
    gets the update the full tensor's optimizer would give it.
    `state_dict` gathers the full state, `load_state_dict` slices it,
    so checkpoints are those of the unsharded optimizer."""

    takes_loss = True   # optimizer_step passes it the loss

    def __init__(self, opt: torch.optim.Optimizer, dims: dict[int, int | None],
                 mesh: Mesh):
        self.opt, self.mesh = opt, mesh
        n, r = mesh.shape["model"], mesh.model_index
        self.shards = []                  # (full param, slice leaf, dim)
        self._index_dims = {}             # state_dict index → dim
        i = 0
        for group in opt.param_groups:
            params = []
            for p in group["params"]:
                if id(p) not in dims:
                    raise ValueError("shard_params: an optimizer holds a "
                                     "parameter of no module in the tree")
                dim = dims[id(p)]
                if dim is not None:
                    s = p.detach().chunk(n, dim)[r].clone()
                    st = opt.state.pop(p, {})
                    opt.state[s] = {k: self._slice(v, p.shape, dim)
                                    for k, v in st.items()}
                    self.shards.append((p, s, dim))
                    self._index_dims[i] = (dim, p.shape)
                    p = s
                params.append(p)
                i += 1
            group["params"] = params

    def _slice(self, v, shape, dim):
        if torch.is_tensor(v) and v.shape == shape:
            return v.chunk(self.mesh.shape["model"], dim)[
                self.mesh.model_index].clone()
        return v

    def _gather(self, s: torch.Tensor, dim: int) -> torch.Tensor:
        s = s.contiguous()
        parts = [torch.empty_like(s) for _ in range(self.mesh.shape["model"])]
        dist.all_gather(parts, s, group=self.mesh.model_group)
        return torch.cat(parts, dim)

    def step(self, value: torch.Tensor | None = None):
        n, r = self.mesh.shape["model"], self.mesh.model_index
        for p, s, dim in self.shards:
            s.grad = (None if p.grad is None
                      else p.grad.chunk(n, dim)[r].contiguous())
        optimizer_step(self.opt, value)
        with torch.no_grad():
            for p, s, dim in self.shards:
                p.copy_(self._gather(s, dim))
                s.grad = None

    def zero_grad(self, set_to_none: bool = True):
        self.opt.zero_grad(set_to_none=set_to_none)
        for p, _, _ in self.shards:
            p.grad = None

    def state_dict(self) -> dict:
        sd = self.opt.state_dict()
        for i, (dim, shape) in self._index_dims.items():
            st = sd["state"].get(i)
            if st:
                sd["state"][i] = {
                    k: (self._gather(v, dim) if torch.is_tensor(v)
                        and v.dim() == len(shape) else v)
                    for k, v in st.items()}
        return sd

    def load_state_dict(self, state_dict: dict):
        sd = dict(state_dict)
        sd["state"] = dict(sd["state"])
        for i, (dim, shape) in self._index_dims.items():
            st = sd["state"].get(i)
            if st:
                sd["state"][i] = {k: self._slice(v, shape, dim)
                                  for k, v in st.items()}
        self.opt.load_state_dict(sd)

    def __getattr__(self, name):
        if name == "opt":
            raise AttributeError(name)
        return getattr(self.opt, name)


def shard_params(tree, mesh: Mesh, min_shard: int = 8):
    """Shard the optimizers of a train state over the mesh's model axis.

    `tree` holds modules and the optimizers of their parameters (a dict,
    list or tuple of them). Everything is first replicated from rank 0;
    then, on a model axis of more than one rank, each optimizer is
    wrapped in a ShardedOptimizer whose split follows `shard_plan` of
    the modules. Returns the tree with the optimizers so wrapped."""
    tree = replicate(tree, mesh)
    n = mesh.shape["model"]
    if n == 1:
        return tree
    dims: dict[int, int | None] = {}

    def plan(x):
        if isinstance(x, nn.Module):
            named = dict(x.named_parameters())
            for name, dim in shard_plan(x, n, min_shard).items():
                dims[id(named[name])] = dim
        return x

    _tree_map(plan, tree)
    return _tree_map(lambda x: ShardedOptimizer(x, dims, mesh)
                     if _is_optimizer(x) else x, tree)


# ---------------------------------------------------------------------------
# Multi-process start-up
# ---------------------------------------------------------------------------

def maybe_initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Start the process group of a multi-process run.

    Returns False and does nothing in a single-process run: no address
    given and none in torchrun's environment (MASTER_ADDR, WORLD_SIZE).
    An already started group returns True. Otherwise the group starts
    with NCCL on the card, or gloo when `device` is the CPU, at
    `coordinator_address` ("host:port" over TCP, or a URL such as
    file:///path) with `num_processes` ranks, this one `process_id`
    (by default WORLD_SIZE and RANK); on the card, the rank's device
    becomes cuda:LOCAL_RANK (by default rank mod the card count)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if (coordinator_address is None and "MASTER_ADDR" in env
            and "WORLD_SIZE" in env):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None:
        raise ValueError("num_processes given without a coordinator address")
    world = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(env.get("RANK", 0) if process_id is None else process_id)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank)
    return True
