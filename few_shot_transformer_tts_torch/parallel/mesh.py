"""The process groups of data- and tensor-parallel training (counterpart of
``few_shot_transformer_tts_tpu/parallel/mesh.py``).

The JAX package runs one jitted program over a ``(data, model)`` mesh: each
process builds a global batch from its own rows (``assemble_global_batch``)
and the step's masked means and BatchNorm statistics run over every row.
The port runs one process per GPU under ``DistributedDataParallel``, started
by ``torchrun`` (``init_distributed``).  Each rank keeps its own rows at its
own padded shape, so ``shard_batch``, ``assemble_global_batch`` and
``pad_batch_to_devices`` have no counterpart here: the one masked mean over
the global batch comes from the all-reduced counts and sums in
``models/common.py:mask_reduce``, ``models/tacotron.py:MaskedBatchNorm`` and
``compute_loss``, which take the grid's ``stats_group``.

The JAX ``(data, model)`` mesh is ``make_grid``'s grid of ranks, rank =
d * model + m: a model group per data index (the tensor-parallel
all-reduces of ``parallel/sharding_rules.py``), and per model index a data
group for DDP and one for the loss and BatchNorm all-reduces.  The ranks of
one model group hold the same rows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import rank_device, resolve_device


def init_distributed(backend: str, device="cuda") -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) over ``backend`` and return this rank's device
    (``local_device``, bound as the current card).  NCCL is initialised
    eagerly on that card, so a failure raises here; nothing falls back to
    another backend."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError("--multihost needs torchrun's environment; %s "
                           "unset" % ", ".join(missing))
    device = local_device(device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda", backend: str = "nccl") -> torch.device:
    """This rank's device: for a card ``cuda:<LOCAL_RANK>``
    (``utils.device.rank_device``; NCCL takes one rank per card), except
    that gloo ranks beyond the host's cards share them round robin (the
    way one card runs two ranks); else ``device``."""
    if torch.device(device).type != "cuda":
        return resolve_device(device)
    if backend == "gloo":
        resolve_device("cuda")
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return rank_device()


def agree_global_shape(batch: dict, device) -> np.ndarray:
    """The elementwise max over ranks of (rows, T_in, T_out) of each rank's
    padded batch (JAX ``agree_global_shape``): an ``all_gather`` of three
    ints.  The step does not need it; the train loop logs it."""
    local = torch.tensor([
        batch["inputs"].shape[0], batch["inputs"].shape[1],
        batch["mel_targets"].shape[1] if "mel_targets" in batch else 0],
        dtype=torch.int64, device=device)
    gathered = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(gathered, local)
    return torch.stack(gathered).max(0).values.cpu().numpy()


def check_mesh(hp, world: int) -> None:
    """The mesh hparams at ``world`` ranks, as JAX ``make_mesh`` asserts
    them: ``mesh_model_axis`` at least 1 and dividing the world size, and
    ``mesh_data_axis`` -1 or the world size over it."""
    model = hp.mesh_model_axis
    if model < 1:
        raise ValueError("mesh_model_axis must be at least 1, got %d" % model)
    if world % model:
        raise ValueError("mesh_model_axis=%d does not divide the %d ranks"
                         % (model, world))
    if hp.mesh_data_axis not in (-1, world // model):
        raise ValueError("mesh_data_axis=%d does not match the %d ranks over "
                         "mesh_model_axis=%d (use -1 or %d)"
                         % (hp.mesh_data_axis, world, model, world // model))


@dataclass(frozen=True)
class Grid:
    """This rank's place in the ``(data, model)`` grid (rank = data_rank *
    model + model_rank) and its groups, each None when it would hold one
    rank: ``model_group`` (the ranks of its data index: the tensor-parallel
    all-reduces), ``data_group`` (the ranks of its model index: DDP's
    gradient averaging) and ``stats_group`` (the same ranks: the loss and
    BatchNorm all-reduces, a group of its own so that they never interleave
    with DDP's buckets on one communicator)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    model_group: Any = None
    data_group: Any = None
    stats_group: Any = None


def make_grid(model: int = 1) -> Grid:
    """The grid of the process group (one process: a grid of one rank, no
    group).  Every rank calls it: creating a group is collective."""
    world, rank = process_count(), process_index()
    if model < 1 or world % model:
        raise ValueError("mesh_model_axis=%d does not divide the %d ranks"
                         % (model, world))
    data = world // model
    d, m = divmod(rank, model)
    groups = {}
    if world > 1:
        # every rank creates every group, in one order
        for dd in range(data):
            g = dist.new_group([dd * model + mm for mm in range(model)])
            if dd == d and model > 1:
                groups["model_group"] = g
        for name in ("data_group", "stats_group"):
            for mm in range(model):
                g = dist.new_group([dd * model + mm for dd in range(data)])
                if mm == m and data > 1:
                    groups[name] = g
    return Grid(data, model, d, m, **groups)
