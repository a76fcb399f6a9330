"""Checkpoints of the port: ``model.ckpt-<step>`` files in the reference torch
format, the JAX package's msgpack and sharded checkpoints read back, and
feeder state.

Counterpart of ``few_shot_transformer_tts_tpu/train/checkpoint.py``
(reference utils/checkpoint.py:8-58).  ``save_state`` writes
``torch.save({model, optim, sched, step})`` through an atomic rename: the
format the reference writes and the JAX package's
``load_reference_checkpoint`` imports, Adam moments included.  ``find_ckpt``
picks the largest step.  ``load_state`` reads three formats
(``checkpoint_format``): that torch format, the JAX package's flax msgpack
``model.ckpt-<step>`` (``train/flax_msgpack.py``) and its sharded
``model.ckpt-<step>.d/shard-<rank>-of-<world>.pkl`` directories
(``load_state_sharded``), whose train state goes through
``converter.from_jax_train_state``.  Data-parallel runs write that sharded
format (``snapshot_local_shards``, ``save_state_sharded``): the replicated
state as the JAX train state tree, each leaf written by the one rank that
owns it; under tensor parallelism each rank's parts of the split leaves are
written as slices of the JAX layout.  ``snapshot`` takes the host copy a
checkpoint of this rank writes (``Snapshot.write``): ``AsyncCheckpointer``
takes it on the caller's thread and runs the encode, the write and the
rename on a writer thread, and the train loop keeps the latest one as its
host mirror for ``crash_save``.  Feeder (data-iterator) state
is saved per rank as ``feeder_<rank>.pkl`` beside every checkpoint, so every
checkpoint is a consistent resume point.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
import threading
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..parallel.sharding_rules import pieces
from . import flax_msgpack
from .converter import (from_jax_train_state, jax_array, jax_index,
                        jax_shape, load_reference_checkpoint,
                        port_train_leaves, unflatten_dict)


def find_ckpt(base_dir: str) -> Optional[str]:
    """Latest model.ckpt-* path — single-file or sharded ``.d`` directory
    (reference utils/checkpoint.py:8-16).  A ``.d`` directory that lacks a
    shard file (``sharded_complete``) is skipped with a warning: the ranks
    that reached ``crash_save`` after one rank failed, or a save cut short,
    leave one."""
    max_step = 0
    result = None
    for f in glob.iglob(os.path.join(base_dir, "model.ckpt-*")):
        step_s = f.split("-")[-1]
        sharded = step_s.endswith(".d") and os.path.isdir(f)
        if sharded:
            step_s = step_s[:-2]
        if not step_s.isdigit() or int(step_s) <= max_step:
            continue
        if sharded and not sharded_complete(f):
            logging.warning("Skipping incomplete checkpoint %s: %s", f,
                            sorted(os.listdir(f)))
            continue
        result = f
        max_step = int(step_s)
    return result


def sharded_complete(ckpt_dir: str) -> bool:
    """Whether ``ckpt_dir`` holds ``shard-<r>-of-<N>.pkl`` for every rank r
    of one world size N, and no other shard file."""
    names = set(n for n in os.listdir(ckpt_dir) if n.endswith(".pkl"))
    worlds = set(n.rsplit("-", 1)[-1][:-4] for n in names)
    if len(worlds) != 1 or not next(iter(worlds)).isdigit():
        return False
    world = int(worlds.pop())
    return names == {"shard-%d-of-%d.pkl" % (r, world) for r in range(world)}


def save_state(model_dir: str, model, optimizer, scheduler, step: int) -> str:
    """Write model.ckpt-<step> in the reference format (atomic rename)."""
    return write_state(model_dir, {"model": model.state_dict(),
                                   "optim": optimizer.state_dict(),
                                   "sched": scheduler.state_dict(),
                                   "step": int(step)})


def write_state(model_dir: str, state: dict) -> str:
    """``torch.save`` a checkpoint dict to model.ckpt-<state["step"]>
    through a ``.tmp`` file and an atomic rename."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "model.ckpt-%d" % state["step"])
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def host_copy(obj):
    """``obj`` with every tensor copied to the host (``.detach().to("cpu",
    copy=True)``) and every dict, list and tuple rebuilt, so nothing in it
    shares storage with the live state."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, host_copy(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


@dataclass
class Snapshot:
    """The host copy of one rank's checkpoint at ``step``: the whole state
    dict of ``save_state`` (``state``), or with ``shards`` this rank's
    share of the sharded format (``snapshot_local_shards``)."""
    step: int
    state: Optional[dict] = None
    shards: Optional[dict] = None
    rank: int = 0
    world: int = 1

    def write(self, model_dir: str) -> str:
        """Write it: ``model.ckpt-<step>``, or this rank's shard file of
        ``model.ckpt-<step>.d``."""
        if self.shards is not None:
            return save_state_sharded(model_dir, self.shards, self.step,
                                      self.rank, self.world)
        return write_state(model_dir, self.state)


def snapshot(model, optimizer, scheduler, step: int, sharded: bool = False,
             rank: int = 0, world: int = 1, grid=None) -> Snapshot:
    """Copy this rank's checkpoint to the host: the model, optimizer and
    scheduler state as ``save_state`` writes them, or with ``sharded`` the
    rank's share of the sharded format (``snapshot_local_shards``; the
    scheduler is not stored, it resumes at the step).  Raises when the
    state cannot be fetched (after a sticky CUDA error every copy to the
    host raises)."""
    if sharded:
        return Snapshot(step, shards=snapshot_local_shards(
            model, optimizer, step, rank, world, grid), rank=rank,
            world=world)
    return Snapshot(step, state=host_copy({
        "model": model.state_dict(), "optim": optimizer.state_dict(),
        "sched": scheduler.state_dict(), "step": int(step)}))


class AsyncCheckpointer:
    """Write checkpoints on a background thread (the JAX package's
    ``AsyncCheckpointer``, its train/checkpoint.py:218-266).

    ``save`` copies the model, optimizer and scheduler state (or, sharded,
    this rank's leaves) to the host on the caller's thread, the only part
    that must precede the next optimizer step (which updates the parameters
    in place), then hands ``torch.save`` or the pickle, and the rename, to a
    writer thread.  A later ``save`` or ``wait`` joins
    the write in flight first; a failed write is logged there, not raised,
    so a checkpoint that cannot be written does not stop training.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> bool:
        """Join the write in flight; False if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            logging.error("Async checkpoint write failed: %r", err)
            return False
        return True

    def _run(self, fn, *args):
        try:
            fn(*args)
        except BaseException as e:   # surfaced on the next wait()
            self._error = e

    def _start(self, target, *args):
        self._thread = threading.Thread(target=target, args=args,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def save(self, model_dir: str, model, optimizer, scheduler, step: int,
             sharded: bool = False, rank: int = 0, world: int = 1,
             grid=None) -> Snapshot:
        """Copy the state to the host now (``snapshot``) and write it on
        the writer thread: ``model.ckpt-<step>``, or with ``sharded`` this
        rank's ``shard-<rank>-of-<world>.pkl`` of ``model.ckpt-<step>.d``
        (every rank calls it).  Returns the snapshot, which nothing else
        writes to."""
        snap = snapshot(model, optimizer, scheduler, step, sharded, rank,
                        world, grid)
        self.wait()
        self._start(self._run, snap.write, model_dir)
        return snap

    def then(self, fn, *args) -> None:
        """Run ``fn(*args)`` on the writer's side once the write in flight
        has landed; skipped when that write failed.  ``wait`` joins it."""
        writer = self._thread

        def run():
            if writer is not None:
                writer.join()
            if self._error is None:
                self._run(fn, *args)
        self._start(run)


def checkpoint_format(path: str) -> str:
    """'torch' (a torch.save zip or legacy pickle), 'msgpack' (flax
    ``to_bytes`` of a train state: a msgpack map) or 'sharded' (a ``.d``
    directory of shard files); anything else raises ValueError."""
    if os.path.isdir(path):
        return "sharded"
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in (b"PK", b"\x80\x02"):        # torch zip / legacy pickle
        return "torch"
    if magic and (0x80 <= magic[0] <= 0x8f or magic[0] in (0xde, 0xdf)):
        return "msgpack"
    raise ValueError("%s is in no checkpoint format the port reads: a torch "
                     "file, a flax msgpack file or a sharded .d directory"
                     % path)


def load_state(path: str, model, optimizer=None, scheduler=None) -> int:
    """Restore model (strictly), and optimizer and scheduler when given,
    from a checkpoint in any ``checkpoint_format``; the step.  From the JAX
    formats the scheduler resumes at the stored step."""
    fmt = checkpoint_format(path)
    if fmt == "torch":
        step = load_reference_checkpoint(path, model, optimizer, scheduler)
    else:
        tree = load_state_sharded(path) if fmt == "sharded" \
            else flax_msgpack.load(path)
        state_dict, optim, step = from_jax_train_state(tree, model, optimizer)
        model.load_state_dict(state_dict, strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(optim)
        if scheduler is not None:
            _resume_schedule(scheduler, step)
    name_step = os.path.basename(path).split("-")[-1]
    if name_step.endswith(".d"):
        name_step = name_step[:-2]
    if step is not None and name_step.isdigit() and int(name_step) != step:
        logging.warning("Step=%d, while checkpoint name says %s", step,
                        name_step)
    return int(step or 0)


def _resume_schedule(scheduler, step: int) -> None:
    """Put a LambdaLR where it stands after ``step`` steps, as a saved
    scheduler state would: ``last_epoch`` and each group's LR."""
    scheduler.last_epoch = step
    lrs = [base * fn(step) for fn, base in zip(scheduler.lr_lambdas,
                                               scheduler.base_lrs)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs


def load_state_sharded(ckpt_dir: str) -> dict:
    """The train-state tree of a ``model.ckpt-<step>.d`` directory, as the
    JAX package's ``load_state_sharded`` reassembles it: each leaf filled
    from the slice indices its shard records carry.  Raises ValueError when
    a shard file is missing, the files disagree on the world size, or a
    leaf is not fully covered; warns when the stored step is not the
    directory's."""
    files = sorted(glob.glob(os.path.join(ckpt_dir, "shard-*.pkl")))
    if not files:
        raise ValueError("no shard files under %s" % ckpt_dir)
    leaves, filled = {}, {}
    step = None
    for fp in files:
        with open(fp, "rb") as f:
            payload = pickle.load(f)
        step = payload["step"]
        if payload["world"] != len(files):
            raise ValueError("expected %d shard files, found %d in %s"
                             % (payload["world"], len(files), ckpt_dir))
        for key, rec in payload["leaves"].items():
            if key not in leaves:
                leaves[key] = np.zeros(rec["shape"], dtype=rec["dtype"])
                filled[key] = 0
            for index, data in rec["shards"]:
                leaves[key][tuple(index)] = data
                filled[key] += int(np.asarray(data).size)
    for key, arr in leaves.items():
        if filled[key] != arr.size:
            raise ValueError("shard coverage mismatch for %s: %d of %d "
                             "elements" % (key, filled[key], arr.size))
    tree = unflatten_dict({tuple(k.split("/")): v for k, v in leaves.items()})
    if step is not None and int(tree["step"]) != int(step):
        logging.warning("Step=%d, while checkpoint dir says %d",
                        int(tree["step"]), int(step))
    return tree


def leaf_owner(key: str, shape, world: int) -> int:
    """The rank that writes a replicated leaf of the sharded format:
    ``crc32("<key>|<index>") % world``, with the index the whole leaf's
    slices as JAX spells them (JAX ``_owner_device`` with one device per
    process, so the JAX package picks the same rank)."""
    index = tuple(slice(None) for _ in shape)
    return zlib.crc32(("%s|%s" % (key, index)).encode()) % world


def piece_owner(key: str, index: tuple, grid) -> int:
    """The rank that writes one part of a tensor-parallel leaf: among the
    ranks that hold it (this model rank at every data index), the one at
    data index ``crc32("<key>|<index>") % data``, as JAX ``_owner_device``
    picks among a shard's replicas."""
    d = zlib.crc32(("%s|%s" % (key, index)).encode()) % grid.data
    return d * grid.model + grid.model_rank


def snapshot_local_shards(model, optimizer, step: int, rank: int,
                          world: int, grid=None) -> dict:
    """This rank's share of the sharded format, on the host, under
    flax-path keys (``params/...``, ``batch_stats/...``,
    ``opt_state/0/{count,mu,nu}/...``, ``opt_state/1/count``, ``step``;
    ``converter.port_train_leaves``): each whole leaf that ``leaf_owner``
    gives this rank, and, under tensor parallelism (``grid``, the rank's
    place in the grid), each part of a split leaf that ``piece_owner`` gives
    it, as a slice of the JAX layout.  Only those leaves are copied to the
    host, and each is a copy, so the next step's in-place updates do not
    reach it."""
    shards = {}
    for key, kind, value, spec in port_train_leaves(model, optimizer, step):
        if spec is None:
            shape = jax_shape(kind, value.shape)
            if leaf_owner(key, shape, world) == rank:
                arr = np.array(jax_array(kind, value))
                shards[key] = {"shape": shape, "dtype": str(arr.dtype),
                               "shards": [(tuple(slice(None) for _ in shape),
                                           arr)]}
            continue
        owned = []
        for index, piece in pieces(value, spec):
            index = jax_index(kind, index)
            if piece_owner(key, index, grid) == rank:
                owned.append((index, np.array(jax_array(kind, piece))))
        if owned:
            shards[key] = {"shape": jax_shape(kind, spec.full_shape),
                           "dtype": str(owned[0][1].dtype), "shards": owned}
    return shards


def save_state_sharded(model_dir: str, shards: dict, step: int, rank: int,
                       world: int) -> str:
    """Write this rank's ``shard-<rank>-of-<world>.pkl`` into
    ``model.ckpt-<step>.d/`` (JAX ``save_state_sharded``): the payload
    ``{rank, world, step, leaves}`` through a ``.tmp`` file and an atomic
    rename.  ``shards``: from ``snapshot_local_shards``.  Every rank calls
    it; the directory is complete once each has."""
    ckpt_dir = os.path.join(model_dir, "model.ckpt-%d.d" % step)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "shard-%d-of-%d.pkl" % (rank, world))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"rank": rank, "world": world, "step": step,
                     "leaves": shards}, f, protocol=4)
    os.replace(tmp, path)
    return ckpt_dir


def save_feeder_state(logdir: str, rank: int, feeder) -> str:
    path = os.path.join(logdir, "feeder_%d.pkl" % rank)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(feeder.state_dict(), f)
    os.replace(tmp, path)
    return path


def maybe_load_feeder_state(logdir: str, rank: int, feeder) -> bool:
    path = os.path.join(logdir, "feeder_%d.pkl" % rank)
    if os.path.exists(path):
        with open(path, "rb") as f:
            feeder.load_state_dict(pickle.load(f))
        return True
    return False
