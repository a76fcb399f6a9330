"""Weight bridge between the port, the JAX package and reference checkpoints.

``state_dict_from_jax_variables`` is the exact inverse of the JAX package's
``convert_torch_state_dict`` (``few_shot_transformer_tts_tpu/train/
converter.py``): it takes the JAX ``{'params', 'batch_stats'}`` tree (numpy
arrays, no JAX types) and returns the port's state dict.
``jax_variables_from_state_dict`` is the port's copy of
``convert_torch_state_dict``: the way back.

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
``from_jax_train_state`` turns a whole JAX train state, as its msgpack and
sharded checkpoints hold it, into the state dict, the Adam state and the
step; for a tensor-parallel model (``parallel/sharding_rules.py``) each split
leaf is cut to the rank's part.  ``port_train_leaves`` walks the port's
state the other way, leaf by leaf, with each split leaf's ``ShardSpec``: the
sharded checkpoint writer records a rank's parts as slices of the JAX
layout (``jax_index``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..parallel.sharding_rules import take


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


def _float32(arr) -> np.ndarray:
    """A numpy or torch leaf (a ``bfloat16`` leaf of a JAX checkpoint is a
    torch tensor) as a float32 numpy copy."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().float().numpy().copy()
    return np.array(arr, dtype=np.float32)


def state_dict_from_jax_variables(variables: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{'params', 'batch_stats'}`` tree -> port state dict
    (fp32 tensors; ``num_batches_tracked`` 0 for every BatchNorm)."""
    out = {}
    for path, arr in _flatten(variables["params"]):
        arr = _float32(arr)
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
        out[owner + ".running_" + leaf] = _float32(arr)
        out[owner + ".num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(v).contiguous() for k, v in out.items()}


def _strip_module(name: str) -> str:
    """Strip DataParallel/DDP prefixes (reference utils/checkpoint.py:21-26)."""
    return name[len("module."):] if name.startswith("module.") else name


_NORM_LAYERS = ("attn_layer_norms", "ffn_layer_norms", "encdec_layer_norms",
                "output_layer_norm", "batchnorm_layers")
_EMBED_LAYERS = ("embed", "speaker_embed")


def _jax_leaf(name: str):
    """(kind, flax path) of a state-dict name, as the JAX package's
    ``_classify`` gives them: ``self_attentions.0.x`` -> ``self_attentions_0
    /x``; kind is 'skip', 'batch_stat', 'pe_scale', 'conv_kernel', 'kernel'
    or 'as_is'."""
    merged = []
    for p in _strip_module(name).split("."):
        if p.isdigit() and merged:
            merged[-1] += "_" + p
        else:
            merged.append(p)
    leaf, path = merged[-1], tuple(merged[:-1])
    owner = merged[-2] if len(merged) >= 2 else ""
    owner_base = owner.rsplit("_", 1)[0] if owner and owner[-1].isdigit() \
        else owner
    if leaf == "num_batches_tracked":
        return "skip", ()
    if leaf in ("running_mean", "running_var"):
        return "batch_stat", path + (leaf[len("running_"):],)
    if leaf == "pe_scale":
        return "pe_scale", tuple(merged)
    if leaf == "weight":
        if owner_base in _NORM_LAYERS:
            return "as_is", path + ("scale",)
        if owner_base in _EMBED_LAYERS:
            return "as_is", path + ("embedding",)
        if owner_base == "conv_layers":
            return "conv_kernel", path + ("kernel",)
        return "kernel", path + ("kernel",)
    if leaf == "bias":
        return "as_is", path + ("bias",)
    raise ValueError("Unrecognized parameter: %s" % name)


def unflatten_dict(flat: dict) -> dict:
    """{(key, ..., leaf): value} -> nested dicts."""
    out = {}
    for path, val in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return out


def jax_array(kind: str, tensor) -> np.ndarray:
    """One leaf in the JAX layout: Linear weights transposed, Conv1d
    weights to [k, in, out], ``pe_scale`` 0-d."""
    arr = tensor.detach().cpu().numpy() \
        if isinstance(tensor, torch.Tensor) else np.asarray(tensor)
    if kind == "pe_scale":
        return arr.reshape(())
    if kind == "conv_kernel":
        return arr.transpose(2, 1, 0)
    if kind == "kernel":
        return arr.T
    return arr


def jax_shape(kind: str, shape) -> tuple:
    """The shape ``jax_array`` gives a leaf of ``shape``."""
    if kind == "pe_scale":
        return ()
    if kind in ("conv_kernel", "kernel"):
        return tuple(shape)[::-1]
    return tuple(shape)


def jax_variables_from_state_dict(state_dict) -> dict:
    """Port (or reference) state dict -> the JAX package's ``{'params',
    'batch_stats'}`` tree of numpy arrays, as its ``convert_torch_state_dict``
    makes it: Linear weights transposed, Conv1d weights to [k, in, out],
    ``pe_scale`` 0-d, running statistics to ``batch_stats`` (left out when
    there are none), ``num_batches_tracked`` dropped."""
    params, batch_stats = {}, {}
    for name, tensor in state_dict.items():
        kind, path = _jax_leaf(name)
        if kind == "skip":
            continue
        (batch_stats if kind == "batch_stat" else params)[path] = \
            jax_array(kind, tensor)
    out = {"params": unflatten_dict(params)}
    if batch_stats:
        out["batch_stats"] = unflatten_dict(batch_stats)
    return out


def local_state_dict(state_dict: dict, model: nn.Module) -> dict:
    """A whole state dict cut to ``model``'s parts: each entry of a
    tensor-parallel parameter (``param.tp``) becomes the rank's part
    (``sharding_rules.take``); the others stay as they are."""
    specs = {n: p.tp for n, p in model.named_parameters()
             if getattr(p, "tp", None) is not None}
    return {k: take(v, specs[k]) if k in specs else v
            for k, v in state_dict.items()}


def optimizer_state_from_jax(mu: dict, nu: dict, count: int,
                             model: nn.Module, optimizer) -> dict:
    """The JAX package's Adam moments (``mu``/``nu`` trees of numpy arrays in
    the params layout, and the step ``count``) as a state dict for
    ``optimizer`` (a ``torch.optim.Adam`` over ``model.parameters()``),
    whose param groups it keeps; cut to a tensor-parallel model's parts."""
    mu_sd = local_state_dict(state_dict_from_jax_variables({"params": mu}),
                             model)
    nu_sd = local_state_dict(state_dict_from_jax_variables({"params": nu}),
                             model)
    names = [name for name, _ in model.named_parameters()]
    if sorted(names) != sorted(mu_sd) or sorted(names) != sorted(nu_sd):
        raise ValueError("the moments do not cover the model's parameters")
    state = {i: {"step": torch.tensor(float(count)),
                 "exp_avg": mu_sd[name], "exp_avg_sq": nu_sd[name]}
             for i, name in enumerate(names)}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def from_jax_train_state(tree: dict, model: nn.Module, optimizer=None):
    """A JAX train state as its checkpoints hold it, ``{step, params,
    batch_stats, opt_state: {"0": {count, mu, nu}, "1": {count}}}`` (optax
    Adam, then its schedule; the layout the JAX ``import_opt_state``
    grafts), -> (the port's state dict, ``optimizer``'s state dict with the
    Adam moments or None without an optimizer, the step), each cut to a
    tensor-parallel model's parts."""
    state_dict = local_state_dict(state_dict_from_jax_variables(
        {"params": tree["params"], "batch_stats": tree.get("batch_stats")
         or {}}), model)
    optim = None
    if optimizer is not None:
        adam = tree["opt_state"]["0"]
        optim = optimizer_state_from_jax(adam["mu"], adam["nu"],
                                         int(adam["count"]), model, optimizer)
    return state_dict, optim, int(tree["step"])


def port_train_leaves(model: nn.Module, optimizer, step: int):
    """Every leaf of the JAX train state of ``model`` and its Adam state, as
    (flax-path key, kind, value, ShardSpec or None): ``params/...`` and
    ``batch_stats/...`` from the state dict, ``opt_state/0/{mu,nu}/...``
    (zeros for a parameter with no Adam state yet), then ``step``,
    ``opt_state/0/count`` and ``opt_state/1/count`` (int32).  A value is the
    port's tensor (``jax_array`` gives its JAX layout); the spec is its
    parameter's ``param.tp`` when it is a tensor-parallel rank's part."""
    params = dict(model.named_parameters())
    for name, tensor in model.state_dict().items():
        kind, path = _jax_leaf(name)
        if kind != "skip":
            group = "batch_stats" if kind == "batch_stat" else "params"
            yield ("/".join((group,) + path), kind, tensor,
                   getattr(params.get(name), "tp", None))
    counts = set()
    for name, p in params.items():
        kind, path = _jax_leaf(name)
        st = optimizer.state.get(p, {})
        if "step" in st:
            counts.add(int(st["step"]))
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            yield ("/".join(("opt_state", "0", slot) + path), kind,
                   st[key] if key in st else torch.zeros_like(p),
                   getattr(p, "tp", None))
    if len(counts) > 1:
        raise ValueError("the parameters' Adam step counts differ: %s"
                         % sorted(counts))
    count = np.asarray(counts.pop() if counts else 0, np.int32)
    for key, value in (("step", np.asarray(step, np.int32)),
                       ("opt_state/0/count", count),
                       ("opt_state/1/count", count.copy())):
        yield key, "as_is", value, None


def jax_index(kind: str, index: tuple) -> tuple:
    """A torch-layout index of a split leaf (a Linear weight, the only kind
    tensor parallelism splits) as an index of its JAX layout."""
    return index[::-1] if kind == "kernel" else index


def jax_train_state_from_port(model: nn.Module, optimizer, step: int
                              ) -> dict:
    """The inverse of ``from_jax_train_state``: the port's model and Adam
    state as the JAX package's train state tree, ``{step, params,
    batch_stats, opt_state: {"0": {count, mu, nu}, "1": {count}}}``, numpy
    leaves in the JAX layout (as ``jax_variables_from_state_dict`` gives
    them), the counts and the step int32 as the JAX trainer keeps them.  A
    parameter with no Adam state yet (no step taken) gets zero moments.  A
    tensor-parallel model has no whole leaves to give and raises ValueError
    (its ranks write ``checkpoint.snapshot_local_shards``)."""
    flat = {}
    for key, kind, tensor, spec in port_train_leaves(model, optimizer, step):
        if spec is not None:
            raise ValueError("%s is a tensor-parallel rank's part; write the "
                             "state with snapshot_local_shards" % key)
        flat[tuple(key.split("/"))] = jax_array(kind, tensor)
    return unflatten_dict(flat)


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
