"""Device mesh and sharding over ``torch.distributed``: the port's ``parallel/mesh.py``.

Counterpart of ``yolo_puncture_tpu/parallel/mesh.py``.  JAX places arrays on a
``Mesh`` and XLA inserts the collectives; here each rank is a process with its
own copy of the program, and the collectives are explicit.  Axes, as in JAX:

  'data'  — batch (frame, video) data parallelism;
  'model' — tensor parallelism: a large kernel's output channels split over the
            ranks of a ``model`` group, its output all-gathered.

JAX's mesh step is the one-device step on the global batch with sharded inputs.
The port computes the same step: ``with mesh:`` installs ``nn/common.py
global_batch`` with a differentiable all-reduce over ``data``, through which the
port's batch-wide reductions run (``BatchNorm2d``'s training sums,
``train/losses.py``'s normalisers), and a trainer
sums its gradients with ``reduce_gradients`` before it uses them.  A stock
``DistributedDataParallel`` would normalise each rank's loss and BatchNorm by
its own shard and average the gradients: another step.

The caller sets up the process group (``process_group``: a rank, a world size,
an init method such as ``tcp://127.0.0.1:<port>`` and a backend: ``nccl`` for
one rank per card, ``gloo`` for CPU ranks and for several ranks on one card,
since NCCL refuses two ranks on one device).  ``spawn_ranks`` starts the ranks.
Only ``all_reduce``, ``broadcast`` and ``all_gather`` are used: gloo has them
for CUDA tensors too (staged through the host).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import multiprocessing.connection
import os
import socket
import tempfile
import time
from collections import Counter
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from yolo_puncture_tpu_torch.nn.common import global_batch

GROUP_TIMEOUT_S = 600.0                 # a collective that waits longer fails its rank


class Mesh:
    """The ranks of the initialised process group laid out on named axes.

    Holds a ``torch.distributed.device_mesh.DeviceMesh`` (``device_mesh``).
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does; ``coordinate`` is this rank's index on each axis; ``group(axis)`` is
    the process group of the ranks that differ from this one only on ``axis``.
    ``with mesh:`` makes this thread's batch-wide reductions global over ``data``
    (``nn/common.py global_batch`` with ``data_sum``).
    ``traffic`` counts the bytes each collective of this mesh has moved
    (``all_reduce``, ``all_gather``, ``broadcast``): one rank's tensors."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.coordinate = dict(zip(self.axis_names, device_mesh.get_coordinate()))
        self.rank = dist.get_rank()
        self.traffic = Counter()
        self._entered = []

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __enter__(self):
        cm = global_batch(self.data_sum, self.shape["data"])
        cm.__enter__()
        self._entered.append(cm)
        return self

    def __exit__(self, *exc):
        return self._entered.pop().__exit__(*exc)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coordinate})"

    # -- collectives, counted --------------------------------------------------

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """Sum ``t`` in place over ``group``."""
        self.traffic["all_reduce"] += t.numel() * t.element_size()
        dist.all_reduce(t, group=group)
        return t

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over ``data``; differentiable (the gradient is summed too)."""
        return _AllSum.apply(t, self, self.group("data"))


class _AllSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: the global sum's
    gradient reaches every rank's own terms (SyncBatchNorm's statistics)."""

    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None, None


class _SumGradOverModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``model``: each rank
    of a ``model`` group computes only its slice's share of a column-parallel
    layer's input gradient."""

    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None, None


class _GatherOverModel(torch.autograd.Function):
    """All-gather of the ranks' slices along ``dim``; the backward takes this
    rank's slice of the gradient.  Everything after the gather is computed the
    same on every rank of the ``model`` group, so a reducing backward (as
    ``torch.distributed.nn.functional.all_gather``'s) would count each gradient
    ``model``-size times."""

    @staticmethod
    def forward(ctx, y, mesh, group, dim, index, size):
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        mesh.traffic["all_gather"] += y.numel() * y.element_size() * size
        dist.all_gather(parts, y, group=group)
        ctx.dim, ctx.start, ctx.k = dim, index * y.shape[dim], y.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.k).contiguous(), None, None, None, None, None


# -- the five names of the JAX module ------------------------------------------


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Tuple[str, ...] = ("data", "model"),
              devices=None) -> Mesh:
    """A mesh over the ranks of the initialised process group.  Default: every
    rank on ``data``, 1 on ``model`` (pure data parallelism); ``shape=(d, m)``
    for data × tensor parallelism, rank ``r`` at ``(r // m, r % m)``.
    ``devices``: where the ranks' tensors live, ``"cuda"`` (the default) or
    ``"cpu"``.  Every rank of the group must call this (it makes the groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    from yolo_puncture_tpu_torch.utils.device import resolve_device

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (parallel.mesh.process_group)")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not lay out {n} ranks")
    device_type = resolve_device(devices).type
    return Mesh(DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axis_names)))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """This rank's slice of the leading dimension of every array (tensor or numpy)
    of ``batch``, chosen by the rank's coordinate on ``axis``: the ranks of a
    ``model`` group get the same slice.  Raises where a leading dimension does not
    divide evenly, as JAX's placement does."""
    n, i = mesh.shape[axis], mesh.coordinate[axis]

    def take(x):
        if x.ndim == 0 or x.shape[0] % n:
            raise ValueError(f"a leading dimension of shape {tuple(x.shape)} does not divide over {n} '{axis}' ranks")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    return _tree_map(take, batch)


def _coalesced(tensors: Sequence[torch.Tensor], op: Callable[[torch.Tensor], None]) -> None:
    """``op`` on one flat buffer per (device, dtype) of ``tensors``, copied back in place."""
    by_kind: Dict[Any, list] = {}
    for t in tensors:
        by_kind.setdefault((t.device, t.dtype), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        op(flat)
        with torch.no_grad():
            torch._foreach_copy_(ts, [p.view_as(t) for t, p in zip(ts, flat.split([t.numel() for t in ts]))])


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` (in place) as the first rank holds it: one
    broadcast per device and type.  Returns the tree."""
    leaves = _leaves(tree)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError("replicate takes a tree of tensors")

    def broadcast(flat):
        mesh.traffic["broadcast"] += flat.numel() * flat.element_size()
        dist.broadcast(flat, src=0)

    _coalesced(leaves, broadcast)
    return tree


def _out_dim(module: nn.Module) -> int:
    """The output-channel dimension of a layer's weight in torch's layout."""
    return 1 if isinstance(module, nn.ConvTranspose2d) else 0


def param_shardings(mesh: Mesh, params, model_axis: str = "model", min_size: int = 2 ** 18) -> Dict[str, Any]:
    """A placement for each parameter: JAX's rule in torch's layout.  A kernel with
    ``ndim >= 2``, at least ``min_size`` elements and an output-channel count that
    the ``model`` size divides is ``Shard(d)`` on its output-channel dimension
    (0 for a convolution ``(O, I/g, kh, kw)`` and a ``Linear`` ``(out, in)``, 1 for
    a transposed convolution ``(I, O, kh, kw)``); every other parameter is
    ``Replicate()``.  ``params``: a module (its layers give each weight's layout)
    or a mapping name → tensor (output channels on dim 0)."""
    from torch.distributed.tensor import Replicate, Shard

    m = mesh.shape[model_axis]
    if isinstance(params, nn.Module):
        owners = dict(params.named_modules())
        items = [(n, p, _out_dim(owners[n.rpartition(".")[0]])) for n, p in params.named_parameters()]
    else:
        items = [(n, p, 0) for n, p in params.items()]
    return {n: Shard(d) if p.ndim >= 2 and p.numel() >= min_size and p.shape[d] % m == 0 else Replicate()
            for n, p, d in items}


def data_parallel_step(mesh: Mesh, step_fn: Callable, donate_state: bool = True) -> Callable:
    """``step_fn(state, batch) → (state, metrics)`` run on this rank's shard of the
    global batch (``shard_batch`` on ``data``) inside ``with mesh:``, so that it
    computes ``step_fn`` on the global batch, as JAX's jitted step with a sharded
    batch does.  What ``step_fn`` must do for that:

      * take every batch-wide reduction over the global batch: under the mesh the
        port's ``BatchNorm2d`` (training statistics) and ``detection_loss``
        (normalisers; its components are then this rank's shares, which sum over
        ``data`` to the global values) do; other code calls ``mesh.data_sum``;
      * sum its gradients with ``reduce_gradients`` before it uses them (norm,
        clip, update), and its reported metrics with ``mesh.data_sum``;
      * leave the state the same on every rank: the same update of the same
        summed gradients does.

    ``donate_state``: torch steps update their state in place, which is what
    donating the state allows; with ``False`` the step gets a deep copy, and the
    caller's state stays as it was."""
    def wrapper(state, batch):
        local = shard_batch(mesh, batch)
        with mesh:
            return step_fn(state if donate_state else copy.deepcopy(state), local)

    return wrapper


# -- tensor parallelism: column-parallel layers -----------------------------------


def _column_parallel_forward(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """This rank's output channels of ``module`` on the full input, all-gathered
    over ``model``.  A grouped convolution takes its groups' input channels too."""
    mesh = module._tensor_parallel
    group, m, j = mesh.group("model"), mesh.shape["model"], mesh.coordinate["model"]
    dim = _out_dim(module)
    k = module.weight.shape[dim] // m
    w = module.weight.narrow(dim, j * k, k)
    b = None if module.bias is None else module.bias.narrow(0, j * k, k)
    x = _SumGradOverModel.apply(x, mesh, group)
    if isinstance(module, nn.Linear):
        return _GatherOverModel.apply(F.linear(x, w, b), mesh, group, -1, j, m)
    groups = module.groups
    if groups > 1:
        ci = x.shape[1] // m
        x, groups = x.narrow(1, j * ci, ci), groups // m
    if isinstance(module, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, b, module.stride, module.padding, module.output_padding, groups,
                               module.dilation)
    else:
        y = F.conv2d(x, w, b, module.stride, module.padding, module.dilation, groups)
    return _GatherOverModel.apply(y, mesh, group, 1, j, m)


def shard_model(mesh: Mesh, model: nn.Module, shardings: Dict[str, Any]) -> list:
    """Make each layer whose weight ``shardings`` places as ``Shard`` compute its
    output-channel slice on this ``model`` rank and all-gather the output (the
    weights stay whole in the module, so state dicts and checkpoints hold full
    tensors; only the slice receives a gradient on this rank, and the bias is
    sliced with the weight).  Does nothing on a ``model`` axis of size 1.  Returns
    the layers' names."""
    from torch.distributed.tensor import Shard

    m = mesh.shape["model"]
    if m == 1:
        return []
    owners = dict(model.named_modules())
    names = []
    for name, placement in shardings.items():
        if not isinstance(placement, Shard):
            continue
        layer_name, _, leaf = name.rpartition(".")
        layer = owners[layer_name]
        if leaf != "weight" or not isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) \
                or placement.dim != _out_dim(layer):
            raise ValueError(f"{name}: only the output channels of a convolution or linear layer's weight shard")
        if isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
            if layer.padding_mode != "zeros" or (layer.groups > 1 and (
                    layer.groups % m or isinstance(layer, nn.ConvTranspose2d))):
                raise ValueError(f"{name}: groups {layer.groups} or padding '{layer.padding_mode}' do not split "
                                 f"over {m} ranks")
        layer._tensor_parallel = mesh
        layer.forward = _column_parallel_forward.__get__(layer)
        names.append(layer_name)
    return names


def sharded_parameter_names(model: nn.Module) -> set:
    """The parameters of the layers ``shard_model`` split (weights and biases)."""
    return {f"{ln}.{pn}" for ln, layer in model.named_modules() if hasattr(layer, "_tensor_parallel")
            for pn, _ in layer.named_parameters(recurse=False)}


def reduce_gradients(mesh: Mesh, named_params: Dict[str, torch.Tensor], sharded=()) -> None:
    """Sum each ``.grad`` of ``named_params`` in place into the global batch's
    gradient, the same on every rank: one all-reduce over every rank per device
    and type.  A ``sharded`` parameter (by name) has only this rank's slice
    filled, so the sum over every rank sums ``data`` and assembles the slices.
    A replicated one has a gradient of its own on each rank of a ``model`` group
    (the same computation; on the card cuDNN's backward need not give the same
    bits twice), so its sum over every rank is divided by the ``model`` size:
    the sum over ``data`` of the group's mean, one value on every rank."""
    m = mesh.shape.get("model", 1)
    _coalesced([p.grad for p in named_params.values()], lambda flat: mesh.all_reduce(flat, dist.group.WORLD))
    replicated = [p.grad for n, p in named_params.items() if n not in sharded]
    if m > 1 and replicated:
        torch._foreach_div_(replicated, float(m))


# -- processes ------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(rank: int, world_size: int, init_method: str, backend: str, device=None):
    """This process as ``rank`` of a group on ``backend`` (``nccl`` or ``gloo``, as
    given: no other is tried), its CUDA device set first where ``device`` is one;
    prints the rank's backend and device; destroys the group on leaving."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    where = f"cuda:{torch.cuda.current_device()}" if device is not None and device.type == "cuda" else "cpu"
    print(f"rank {rank} of {world_size}: backend {dist.get_backend()}, device {where}", flush=True)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_entry(fn, rank, world_size, init_method, out_dir, threads, tf32, args):
    if threads:
        torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    result = fn(rank, world_size, init_method, *args)
    torch.save(result, os.path.join(out_dir, f"{rank}.pt"))


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), timeout: Optional[float] = 600.0,
                threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size`` new
    processes (the ``spawn`` start method; ``fn`` a module-level function), with
    ``init_method`` ``tcp://127.0.0.1:<free port>``, and return their results by
    rank (each saved with ``torch.save``).  The parent waits at most ``timeout``
    seconds (None: as long as the ranks run): a rank that exits non-zero, or is
    still running then, makes this kill the others and raise.  ``threads``:
    torch's threads in each rank.  Each rank computes with this process's TF32
    switches."""
    ctx = torch.multiprocessing.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_entry, args=(fn, r, world_size, init_method, out_dir, threads, tf32, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = None if timeout is None else time.monotonic() + timeout
            pending = list(procs)
            while pending:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise RuntimeError(f"ranks {[procs.index(p) for p in pending]} still running after {timeout} s")
                ready = multiprocessing.connection.wait([p.sentinel for p in pending], timeout=left)
                for p in [p for p in pending if p.sentinel in ready]:
                    p.join()
                    pending.remove(p)
                    if p.exitcode != 0:
                        raise RuntimeError(f"rank {procs.index(p)} of {world_size} exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False) for r in range(world_size)]
