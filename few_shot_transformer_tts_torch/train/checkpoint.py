"""Checkpoints of the port: ``model.ckpt-<step>`` files in the reference torch
format, and feeder state.

Counterpart of ``few_shot_transformer_tts_tpu/train/checkpoint.py``
(reference utils/checkpoint.py:8-58).  ``save_state`` writes
``torch.save({model, optim, sched, step})`` through an atomic rename: the
format the reference writes and the JAX package's
``load_reference_checkpoint`` imports, Adam moments included.  ``find_ckpt``
picks the largest step.  Feeder (data-iterator) state is saved per rank as
``feeder_<rank>.pkl`` beside every checkpoint, so every checkpoint is a
consistent resume point.  The JAX package's msgpack, sharded and
asynchronous checkpoints are not ported.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
from typing import Optional

import torch

from .converter import load_reference_checkpoint


def find_ckpt(base_dir: str) -> Optional[str]:
    """Latest model.ckpt-* path — single-file or sharded ``.d`` directory
    (reference utils/checkpoint.py:8-16)."""
    max_step = 0
    result = None
    for f in glob.iglob(os.path.join(base_dir, "model.ckpt-*")):
        step_s = f.split("-")[-1]
        if step_s.endswith(".d") and os.path.isdir(f):
            step_s = step_s[:-2]
        if not step_s.isdigit():
            continue
        step = int(step_s)
        if step > max_step:
            result = f
            max_step = step
    return result


def save_state(model_dir: str, model, optimizer, scheduler, step: int) -> str:
    """Write model.ckpt-<step> in the reference format (atomic rename)."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "model.ckpt-%d" % step)
    tmp = path + ".tmp"
    torch.save({"model": model.state_dict(),
                "optim": optimizer.state_dict(),
                "sched": scheduler.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def load_state(path: str, model, optimizer=None, scheduler=None) -> int:
    """Restore model, optimizer and scheduler from ``path``; the step."""
    step = load_reference_checkpoint(path, model, optimizer, scheduler)
    expected = path.split("-")[-1]
    if step is not None and expected.isdigit() and int(expected) != step:
        logging.warning("Step=%d, while checkpoint name says %s", step,
                        expected)
    return int(step or 0)


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
