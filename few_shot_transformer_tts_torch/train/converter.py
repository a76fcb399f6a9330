"""Weight bridge between the port, the JAX package and reference checkpoints.

``state_dict_from_jax_variables`` is the exact inverse of the JAX package's
``convert_torch_state_dict`` (``few_shot_transformer_tts_tpu/train/
converter.py``): it takes the JAX ``{'params', 'batch_stats'}`` tree (numpy
arrays, no JAX types) and returns the port's state dict.

  flax Dense kernel [in, out]      -> Linear weight [out, in]
  flax Conv kernel [k, in, out]    -> Conv1d weight [out, in, k]
  norm 'scale'                     -> 'weight'
  Embed 'embedding'                -> 'weight'
  batch_stats mean / var           -> running_mean / running_var
  pe_scale ()                      -> pe_scale [1]

``load_reference_checkpoint`` loads a reference-format ``model.ckpt-<step>``
(``torch.save({model, optim, sched, step})``) into a port model, and its
optimizer and LR scheduler when given.  ``optimizer_state_from_jax`` turns
the JAX package's Adam moments into a ``torch.optim.Adam`` state dict, in
``model.parameters()`` order (the order the JAX package's
``_param_names_in_order`` assumes when it imports a torch optimizer).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def _flatten(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _torch_path(path) -> str:
    """('encoder', 'self_attentions_0', ...) -> 'encoder.self_attentions.0...'"""
    parts = []
    for p in path:
        base, _, idx = p.rpartition("_")
        parts.extend([base, idx] if base and idx.isdigit() else [p])
    return ".".join(parts)


def state_dict_from_jax_variables(variables: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{'params', 'batch_stats'}`` tree -> port state dict
    (fp32 tensors; ``num_batches_tracked`` 0 for every BatchNorm)."""
    out = {}
    for path, arr in _flatten(variables["params"]):
        arr = np.array(arr, dtype=np.float32)
        owner, leaf = _torch_path(path[:-1]), path[-1]
        if leaf == "pe_scale":
            out[_torch_path(path)] = arr.reshape(1)
        elif leaf == "kernel" and arr.ndim == 3:
            out[owner + ".weight"] = arr.transpose(2, 1, 0)
        elif leaf == "kernel":
            out[owner + ".weight"] = arr.T
        elif leaf in ("scale", "embedding"):
            out[owner + ".weight"] = arr
        elif leaf == "bias":
            out[owner + ".bias"] = arr
        else:
            raise ValueError("Unrecognized JAX parameter: %s" % "/".join(path))
    for path, arr in _flatten(variables.get("batch_stats", {})):
        owner, leaf = _torch_path(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise ValueError("Unrecognized batch statistic: %s"
                             % "/".join(path))
        out[owner + ".running_" + leaf] = np.array(arr, np.float32)
        out[owner + ".num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(v).contiguous() for k, v in out.items()}


def _strip_module(name: str) -> str:
    """Strip DataParallel/DDP prefixes (reference utils/checkpoint.py:21-26)."""
    return name[len("module."):] if name.startswith("module.") else name


def optimizer_state_from_jax(mu: dict, nu: dict, count: int,
                             model: nn.Module, optimizer) -> dict:
    """The JAX package's Adam moments (``mu``/``nu`` trees of numpy arrays in
    the params layout, and the step ``count``) as a state dict for
    ``optimizer`` (a ``torch.optim.Adam`` over ``model.parameters()``),
    whose param groups it keeps."""
    mu_sd = state_dict_from_jax_variables({"params": mu})
    nu_sd = state_dict_from_jax_variables({"params": nu})
    names = [name for name, _ in model.named_parameters()]
    if sorted(names) != sorted(mu_sd) or sorted(names) != sorted(nu_sd):
        raise ValueError("the moments do not cover the model's parameters")
    state = {i: {"step": torch.tensor(float(count)),
                 "exp_avg": mu_sd[name], "exp_avg_sq": nu_sd[name]}
             for i, name in enumerate(names)}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def load_reference_checkpoint(path: str, model: nn.Module, optimizer=None,
                              scheduler=None) -> Optional[int]:
    """Load a reference ``model.ckpt-<step>`` file into ``model`` (strict),
    ``optimizer`` and ``scheduler`` (when given and present in the file) and
    return its step (``step``, else ``sched['last_epoch']``, else None).

    ``module.`` prefixes are stripped, and a one-element ``pe_scale`` takes
    the port's shape."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model_sd = state.get("model", state)
    own = model.state_dict()
    sd = {}
    for name, tensor in model_sd.items():
        name = _strip_module(name)
        if name.endswith("pe_scale") and name in own:
            tensor = torch.as_tensor(tensor).reshape(own[name].shape)
        sd[name] = tensor
    model.load_state_dict(sd, strict=True)
    if optimizer is not None and state.get("optim"):
        optimizer.load_state_dict(state["optim"])
    if scheduler is not None and isinstance(state.get("sched"), dict):
        scheduler.load_state_dict(state["sched"])
    step = state.get("step", None)
    if step is None and isinstance(state.get("sched"), dict):
        step = state["sched"].get("last_epoch")  # reference checkpoint.py:53-57
    return step
