"""The (data, model) mesh and the shard specs of the parameters (counterpart
of vitax/parallel/mesh.py).

vitax lays its devices out as `reshape(n_data, n_model)` and lets XLA place
the collectives. The port lays its processes out the same way: rank r sits
at data index r // n_model and model index r % n_model, and a `Mesh` holds
the two process groups a rank takes part in:

  * `data` — the ranks with its model index: each runs its rows of the
    global batch (`batch_rows`), and the grads and the eval metrics are
    summed over this group (train/steps.py, train/resvit_steps.py);
  * `model` — the ranks with its data index: Megatron tensor parallelism,
    attention heads and the MLP hidden dim split over it, one all-reduce
    per half-block (parallel/tp_kernels.py).

Parameters live whole on every rank except the tensor-parallel ones, which
`shard_params` cuts by the specs of vitax's `_vit_param_spec` and
`_resvit_param_spec`; an optimizer built over the shards keeps its state
per shard, which is what vitax's `opt_state_shardings` arranges.
`gather_params` puts the whole tensors back together (for a checkpoint)
with an all-reduce of zero-filled tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from vitax_torch.parallel.distributed import all_reduce, initialized, \
    world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on an (n_data, n_model) mesh and its two process
    groups."""
    n_data: int
    n_model: int
    rank: int
    data_group: Any
    model_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over the ranks of the process group (every rank
    calls this, in the same order as its other collectives). n_data
    defaults to world size // n_model."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    data_group = model_group = None
    # new_group is collective: every rank creates every group, in one order
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            data_group = g
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks)
        if rank in ranks:
            model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


def cli_mesh(n_gpu: int, n_model: int = 1) -> Optional[Mesh]:
    """The CLIs' mesh (vitax/train_cli.py:244-251): `--n-gpu` processes (0:
    the world size), n_gpu // n_model on the data axis. None for one
    process without a process group, which runs as before. The world must
    be the `--n-gpu` processes: one process per card, as torchrun starts
    them."""
    world = world_size()
    n = n_gpu or world
    if n != world or n % n_model:
        raise ValueError(
            f"--n-gpu {n_gpu} --n-model {n_model}: this run has {world} "
            "process(es), and a (data, model) mesh runs one process per "
            "card: launch it with torchrun --nproc_per_node N -m "
            "vitax_torch.train_cli --n-gpu N [--n-model M] (N a multiple "
            "of M)")
    if not initialized():
        return None
    return make_mesh(n // n_model, n_model)


def tp_size(mesh: Optional[Mesh]) -> int:
    return mesh.n_model if mesh is not None else 1


def batch_rows(mesh: Optional[Mesh], batch: int) -> slice:
    """This rank's rows of a global batch of `batch` rows: the data axis
    splits it evenly, as vitax's batch sharding does."""
    if mesh is None:
        return slice(0, batch)
    if batch % mesh.n_data:
        raise ValueError(f"batch {batch} does not split over the mesh's "
                         f"{mesh.n_data} data ranks")
    per = batch // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def local_rows(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of `t`, a tensor of the global batch."""
    return t if mesh is None else t[batch_rows(mesh, t.shape[0])]


def draw_rows(mesh: Optional[Mesh], shape, draw: Callable) -> torch.Tensor:
    """`draw(global shape)` for this rank's rows: random numbers of the
    global batch (shape[0] rows a rank, times the data axis), drawn from the
    same generator on every rank and cut by data index, so that a
    data-parallel run draws what one process draws."""
    n = 1 if mesh is None else mesh.n_data
    full = draw((shape[0] * n, *shape[1:]))
    return local_rows(mesh, full)


# ---------------------------------------------------------------------------
# shard specs: vitax's, by parameter path
# ---------------------------------------------------------------------------

def vit_param_spec(path: str) -> Spec:
    """vitax's `_vit_param_spec` (vitax/parallel/mesh.py:54-72) for a leaf of
    one layer (vitax's leaves carry a leading layer axis, which the port's
    per-layer dicts do not): q/k/v kernels [D,H,Hd] and biases [H,Hd] split
    their heads, the out kernel [H,Hd,D] its heads; fc1 [D,M] and its bias
    split M, fc2 [M,D] splits M; everything else whole."""
    if "attn" in path:
        if "out" in path:
            return (MODEL_AXIS,) if path.endswith("kernel") else ()
        return ((None, MODEL_AXIS) if path.endswith("kernel")
                else (MODEL_AXIS,))
    if "mlp" in path:
        if "fc1" in path:
            return ((None, MODEL_AXIS) if path.endswith("kernel")
                    else (MODEL_AXIS,))
        if "fc2" in path and path.endswith("kernel"):
            return (MODEL_AXIS,)
    return ()


def resvit_param_spec(path: str) -> Spec:
    """vitax's `_resvit_param_spec` (vitax/parallel/mesh.py:93-111):
    wq/wk/wv column-parallel (output dim, and their biases), wo row-parallel
    (input dim), fc1's output and fc2's input; routers, approximators, LoRA
    adapters, norms and embeddings whole."""
    is_kernel = path.endswith("kernel")
    if "/attention/" in path and "lora" not in path:
        if "/wo/" in path:
            return (MODEL_AXIS,) if is_kernel else ()
        if any(f"/{w}/" in path for w in ("wq", "wk", "wv")):
            return (None, MODEL_AXIS) if is_kernel else (MODEL_AXIS,)
    if "/feed_forward/" in path:
        if "/fc1/" in path:
            return (None, MODEL_AXIS) if is_kernel else (MODEL_AXIS,)
        if "/fc2/" in path and is_kernel:
            return (MODEL_AXIS,)
    return ()


def _map(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def _axis(spec: Spec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_params(params: Any, mesh: Optional[Mesh],
                 spec: Callable[[str], Spec] = vit_param_spec) -> Any:
    """This rank's shards of whole parameters: each leaf whose spec names the
    model axis cut into n_model equal slices along it, the model index's
    kept (contiguous); the others as they are. The identity without tensor
    parallelism."""
    if tp_size(mesh) == 1:
        return params

    def cut(path, t):
        axis = _axis(spec(path))
        if axis is None:
            return t
        if t.shape[axis] % mesh.n_model:
            raise ValueError(f"{path}: {tuple(t.shape)} does not split over "
                             f"{mesh.n_model} model ranks")
        return t.chunk(mesh.n_model, axis)[mesh.model_index].clone() \
            .contiguous()
    return _map(cut, params)


def gather_shards(path: str, t: torch.Tensor, mesh: Optional[Mesh],
                  spec: Callable[[str], Spec]) -> torch.Tensor:
    """The whole tensor of leaf `path` from this rank's shard `t` (every rank
    of the model group calls this): the shard written into its slot of a
    zero-filled whole tensor, then summed over the model group."""
    axis = _axis(spec(path))
    if tp_size(mesh) == 1 or axis is None:
        return t
    shape = list(t.shape)
    shape[axis] *= mesh.n_model
    whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
    whole.narrow(axis, mesh.model_index * t.shape[axis],
                 t.shape[axis]).copy_(t.detach())
    return all_reduce(whole, mesh.model_group)


def gather_params(params: Any, mesh: Optional[Mesh],
                  spec: Callable[[str], Spec] = vit_param_spec) -> Any:
    """Whole parameters from this rank's shards (the inverse of
    `shard_params`); the identity without tensor parallelism."""
    if tp_size(mesh) == 1:
        return params
    return _map(lambda path, t: gather_shards(path, t, mesh, spec), params)
