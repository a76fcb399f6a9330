"""The process group of data-parallel training (counterpart of
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
``compute_loss``, which take the group of ``make_stats_group``.  The ``model``
mesh axis (tensor parallelism) is not ported (``check_mesh``).
"""

from __future__ import annotations

import os
from typing import Optional

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


def make_stats_group() -> Optional["dist.ProcessGroup"]:
    """A new group over every rank for the loss and BatchNorm all-reduces
    at world > 1, else None (one process: the single-process path, no
    collective).  A group of its own, so these collectives never interleave
    with DDP's gradient buckets on one communicator.  Every rank calls it
    (creating a group is collective)."""
    if process_count() == 1:
        return None
    return dist.new_group(list(range(process_count())))


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
    """The mesh hparams at ``world`` ranks: ``mesh_data_axis`` must be -1
    or the world size (as JAX ``make_mesh`` asserts); a ``mesh_model_axis``
    above 1 (tensor parallelism) is not ported."""
    if hp.mesh_model_axis > 1:
        raise ValueError(
            "mesh_model_axis=%d: tensor parallelism is not ported (ROADMAP "
            "A3b); the port trains data parallel only" % hp.mesh_model_axis)
    if hp.mesh_model_axis < 1:
        raise ValueError("mesh_model_axis must be 1, got %d"
                         % hp.mesh_model_axis)
    if hp.mesh_data_axis not in (-1, world):
        raise ValueError("mesh_data_axis=%d does not match the %d ranks "
                         "(use -1 or the world size)"
                         % (hp.mesh_data_axis, world))
