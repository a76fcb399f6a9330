"""The port's one-pass Adam (``ops/fused_adam.py``) against the JAX
package's ``fused_adam_step``, on the CPU.

- ``FusedAdam`` under ``LambdaLR`` against ``fused_adam_step`` over 3
  steps of the JAX test's tree plus one 8192 x 128 leaf, which alone takes
  the Pallas kernel (in interpret mode) on the JAX side and the kernel's
  route on the port's: parameters and moments within rtol 2e-5, atol 2e-6
  (the JAX test's bar for the kernel against optax; read: moments within
  9e-8, about one ulp, parameters of magnitude up to 5 within 4.8e-7, at
  most 2% of the bar, the kernel leaf as the others; the bias corrections
  are float64 in the port and fp32 in the JAX package), equal step counts,
  and each step's LR the schedule at the pre-increment count.
- A ``FusedAdam`` state dict loads into ``torch.optim.Adam`` and the
  reverse, through ``torch.save``, and the next step agrees within 1e-7
  absolute (Adam's ``lerp`` and its bias-corrected denominator round
  differently; read 7.5e-9).
- Moments carried over from the JAX package by ``optimizer_state_from_jax``
  continue under ``FusedAdam`` as under ``fused_adam_step`` (within 1e-6).
- A group whose step counts differ is refused.
- ``adam_leaves`` on CPU lists: the same bits as ``adam_leaf_plain`` leaf
  by leaf, and the JAX kernel mapped over the leaves in interpret mode
  within rtol 2e-5, atol 2e-6 (the bar above); the list rule it checks
  once over the list (``check_leaves``); ``FusedAdam`` hands a group's
  kernel leaves to one ``adam_leaves`` call.
- At ``default_config()`` the kernel leaves are the 37 leaves the JAX
  package routes to its kernel, by name through the converter.
- The training CLI with ``use_fused_adam=True`` trains, saves a checkpoint
  that ``torch.optim.Adam`` restores, and resumes.
"""

import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from few_shot_transformer_tts_tpu.config import default_config as jax_cfg
from few_shot_transformer_tts_tpu.config import \
    small_test_config as jax_small_cfg
from few_shot_transformer_tts_tpu.models import ByteToMel as JaxByteToMel
from few_shot_transformer_tts_tpu.models.tacotron import \
    learning_rate_schedule as jax_lr
from few_shot_transformer_tts_tpu.ops import fused_adam as jax_fused_adam
from few_shot_transformer_tts_tpu.train.loop import \
    make_optimizer as jax_make_optimizer
from few_shot_transformer_tts_torch.config import (default_config,
                                                   small_test_config)
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.ops import cuda_build
from few_shot_transformer_tts_torch.ops import fused_adam
from few_shot_transformer_tts_torch.ops.fused_adam import (
    FusedAdam, kernel_leaf_params)
from few_shot_transformer_tts_torch.train import cli
from few_shot_transformer_tts_torch.train.converter import (
    optimizer_state_from_jax, state_dict_from_jax_variables)
from few_shot_transformer_tts_torch.train.loop import make_optimizer

from test_torch_train_cli import (  # noqa: F401  (fixtures)
    HP_SPEC, _argv, _keep_root_logger, corpus)
from test_torch_train import _random_grads
from test_torch_weights import example_batch, jax_variables, port_model

SCHEDULE = dict(warmup_steps=2, max_lr=1e-3, min_lr=1e-5, lr_decay_step=10,
                lr_decay_rate=0.5)
HP = default_config(use_fused_adam=True, **SCHEDULE)
JHP = jax_cfg(**SCHEDULE)


def _tree(seed):
    """The tree of tests/test_fused_adam.py (numpy leaves), whose leaves all
    take the plain update, and one leaf of 2^20 elements that takes the
    kernel (8192 x 128: 2-D, minor dimension % 128 == 0)."""
    rng = np.random.RandomState(seed)
    return {"big": rng.randn(512, 128).astype(np.float32),
            "wide": rng.randn(300, 256).astype(np.float32),
            "small": {"w": rng.randn(40, 80).astype(np.float32),
                      "b": rng.randn(80).astype(np.float32)},
            "kernel": rng.randn(8192, 128).astype(np.float32)}


def _flat(tree):
    return {"big": tree["big"], "wide": tree["wide"],
            "small_w": tree["small"]["w"], "small_b": tree["small"]["b"],
            "kernel": tree["kernel"]}


def _port_steps(params, grad_trees):
    """FusedAdam + LambdaLR through make_optimizer: (params, state, LRs)."""
    module = nn.Module()
    for name, arr in _flat(params).items():
        module.register_parameter(name, nn.Parameter(torch.from_numpy(
            arr.copy())))
    optimizer, scheduler = make_optimizer(module, HP)
    assert isinstance(optimizer, FusedAdam)
    named = dict(module.named_parameters())
    lrs = []
    for g in grad_trees:
        for name, arr in _flat(g).items():
            named[name].grad = torch.from_numpy(arr.copy())
        lrs.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        scheduler.step()
    return named, optimizer, lrs


def _jax_steps(params, grad_trees, monkeypatch):
    routed = []
    step = _jax_step(JHP, monkeypatch, routed)
    params = jax.tree.map(jnp.asarray, params)
    state = jax_make_optimizer(JHP).init(params)
    for g in grad_trees:
        params, state = step(jax.tree.map(jnp.asarray, g), state, params)
    return params, state, routed


def _jax_step(jhp, monkeypatch, routed=None):
    """``fused_adam_step`` with its Pallas kernel in interpret mode, jitted
    (the route is chosen while tracing).  The shapes of the leaves that
    reach the Pallas kernel while tracing go to ``routed``."""
    monkeypatch.setenv("FSTTS_PALLAS_INTERPRET", "1")
    if routed is not None:
        pallas = jax_fused_adam._adam_leaf_pallas

        def counted(p, *args, **kwargs):
            routed.append(tuple(p.shape))
            return pallas(p, *args, **kwargs)
        monkeypatch.setattr(jax_fused_adam, "_adam_leaf_pallas", counted)
    return jax.jit(lambda g, s, p: jax_fused_adam.fused_adam_step(g, s, p,
                                                                  jhp))


def test_fused_adam_matches_the_jax_kernel_over_steps(monkeypatch):
    params = _tree(0)
    grads = [_tree(s) for s in range(1, 4)]
    want_p, want_state, routed = _jax_steps(params, grads, monkeypatch)
    named, optimizer, _ = _port_steps(params, grads)
    # the 2^20-element leaf, and only it, takes the kernel on both sides
    assert routed == [(8192, 128)]
    assert optimizer._kernel_ids == {id(named["kernel"])}
    adam, sched = want_state
    assert int(adam.count) == int(sched.count) == 3
    for key, want in (("param", want_p), ("exp_avg", adam.mu),
                      ("exp_avg_sq", adam.nu)):
        for name, arr in _flat(jax.tree.map(np.asarray, want)).items():
            p = named[name]
            got = p.detach() if key == "param" else optimizer.state[p][key]
            np.testing.assert_allclose(got.numpy(), arr, rtol=2e-5,
                                       atol=2e-6, err_msg="%s %s"
                                       % (key, name))
    assert all(float(optimizer.state[p]["step"]) == 3.0
               for p in named.values())


def test_lr_is_the_schedule_at_the_pre_increment_count():
    """Constant gradients: a bias-corrected Adam step moves each weight by
    about the LR it consumed, which must be lr(k) at step k + 1 (the decay
    starts after warmup_steps=2, so steps 1-3 and 4 differ)."""
    ones = jax.tree.map(np.ones_like, _tree(0))
    grad = jax.tree.map(lambda a: np.full_like(a, 0.5), ones)
    named, optimizer, lrs = _port_steps(ones, [grad] * 3)
    before = named["big"].detach().clone()
    named["big"].grad = torch.full_like(before, 0.5)
    lrs.append(optimizer.param_groups[0]["lr"])
    optimizer.step()
    delta = (before - named["big"].detach()).abs().max().item()
    want = [float(jax_lr(jnp.asarray(k), JHP)) for k in range(4)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    assert want[3] < want[2]
    assert delta == pytest.approx(want[3], rel=1e-3)


def _linear_model():
    """A 2^20-element kernel leaf (JAX layout [256, 4096]) and a bias."""
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(256, 4096))


def _grads(model, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)


@pytest.mark.parametrize("first", ["fused", "adam"])
def test_state_dict_moves_between_fused_adam_and_adam(first):
    hp = default_config(**SCHEDULE)
    a, b = _linear_model(), _linear_model()
    opt_a, sched_a = make_optimizer(a, hp.replace(
        use_fused_adam=first == "fused"))
    assert len(kernel_leaf_params(a)) == 1
    for step in range(2):
        _grads(a, step)
        opt_a.step()
        sched_a.step()
    b.load_state_dict(a.state_dict())
    opt_b, sched_b = make_optimizer(b, hp.replace(
        use_fused_adam=first != "fused"))
    assert type(opt_a) is not type(opt_b)
    sd = opt_a.state_dict()
    assert sorted(sd["param_groups"][0]) == \
        sorted(opt_b.state_dict()["param_groups"][0])
    assert all(sorted(s) == ["exp_avg", "exp_avg_sq", "step"]
               for s in sd["state"].values())
    buf = io.BytesIO()     # through a file, as a checkpoint goes
    torch.save({"optim": sd, "sched": sched_a.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    opt_b.load_state_dict(saved["optim"])
    sched_b.load_state_dict(saved["sched"])
    for model, opt, sched in ((a, opt_a, sched_a), (b, opt_b, sched_b)):
        _grads(model, 9)
        opt.step()
        sched.step()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=0, atol=1e-7, err_msg=name)
        assert float(opt_b.state[pb]["step"]) == 3.0


def test_moments_from_jax_continue_under_fused_adam(monkeypatch):
    """``optimizer_state_from_jax`` hands the JAX package's moments to
    FusedAdam: 3 steps of ``fused_adam_step``, then 3 more on each side
    from that state, parameters within 1e-6 (the bar
    ``tests/test_torch_train.py`` sets for torch.optim.Adam)."""
    hp_kw = dict(warmup_steps=1, lr_decay_step=4, lr_decay_rate=0.1)
    jhp = jax_small_cfg(**hp_kw)
    variables = jax_variables(6)
    params = variables["params"]
    step = _jax_step(jhp, monkeypatch)
    state = jax_make_optimizer(jhp).init(params)
    for i in range(3):
        params, state = step(_random_grads(params, 100 + i), state, params)
    model = port_model({"params": jax.tree.map(np.asarray, params),
                        "batch_stats": variables["batch_stats"]})
    optimizer, scheduler = make_optimizer(
        model, small_test_config(use_fused_adam=True, **hp_kw))
    with warnings.catch_warnings():   # no updates yet: torch warns
        warnings.simplefilter("ignore")
        for _ in range(3):
            scheduler.step()
    adam = state[0]
    optimizer.load_state_dict(optimizer_state_from_jax(
        jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        int(adam.count), model, optimizer))
    named = dict(model.named_parameters())
    for i in range(3):
        g = _random_grads(params, i)
        params, state = step(g, state, params)
        for name, t in state_dict_from_jax_variables({"params": g}).items():
            named[name].grad = t
        optimizer.step()
        scheduler.step()
    want = state_dict_from_jax_variables(
        {"params": jax.tree.map(np.asarray, params)})
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert float(optimizer.state[named["decoder.stop_net.bias"]]["step"]) \
        == 6.0


def test_kernel_leaves_are_the_jax_packages():
    """The flagship's kernel leaves by the port's predicate equal the JAX
    package's routing of its own init tree (``jax.eval_shape``), mapped
    to port names through the converter."""
    jhp = jax_cfg()
    batch = example_batch(jhp)
    shapes = jax.eval_shape(lambda key: JaxByteToMel(jhp).init(
        {"params": key, "dropout": key}, **batch, train=True),
        jax.random.PRNGKey(0))["params"]
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    chosen = {}
    for path, leaf in leaves:
        if (leaf.size >= jax_fused_adam._MIN_FUSED_SIZE and
                leaf.dtype == jnp.float32 and leaf.ndim == 2 and
                leaf.shape[-1] % 128 == 0):
            node = chosen
            keys = [k.key for k in path]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.zeros((1, 1), np.float32)
    want = sorted(state_dict_from_jax_variables({"params": chosen}))
    with torch.device("meta"):
        model = ByteToMel(default_config(), device="meta")
    ids = {id(p) for p in kernel_leaf_params(model)}
    got = sorted(n for n, p in model.named_parameters() if id(p) in ids)
    assert got == want and len(got) == 37
    assert sum(p.numel() for p in kernel_leaf_params(model)) == 61_661_184


LEAF_SHAPES = [(64, 128), (300, 256), (40, 80), (7,)]


def _leaves(seed):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * scale).astype(np.float32) ** power
             for s in LEAF_SHAPES]
            for scale, power in ((0.05, 1), (1e-2, 1), (1e-3, 1), (1e-3, 2))]


def test_adam_leaves_matches_per_leaf_plain_and_the_jax_kernel():
    p, g, m, v = _leaves(11)
    a = float(np.float32(1e-3 / (1 - 0.9 ** 10)))
    r = float(np.float32((1 - 0.999 ** 10) ** -0.5))
    coef = (a, r, 0.9, 0.999, 1e-8)
    t = lambda xs: [torch.from_numpy(x.copy()) for x in xs]
    pk, mk, vk = t(p), t(m), t(v)
    before = fused_adam.adam_leaves.launches
    fused_adam.adam_leaves(pk, t(g), mk, vk, *coef)
    assert fused_adam.adam_leaves.launches == before    # CPU: no kernel
    scalars = jnp.asarray([a, r], jnp.float32)
    for i in range(len(LEAF_SHAPES)):
        pp, mp, vp = t([p[i]]), t([m[i]]), t([v[i]])
        fused_adam.adam_leaf_plain(pp, t([g[i]]), mp, vp, *coef)
        for got, want in ((pk[i], pp[0]), (mk[i], mp[0]), (vk[i], vp[0])):
            assert torch.equal(got, want)
        jp, jm, jv = jax_fused_adam._adam_leaf_pallas(
            *(jnp.asarray(x[i]) for x in (p, g, m, v)), scalars, b1=0.9,
            b2=0.999, eps=1e-8, interpret=True)
        for got, want in ((pk[i], jp), (mk[i], jm), (vk[i], jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-5, atol=2e-6)


def test_adam_leaves_checks_the_whole_list():
    def lists(n=3):
        return [[torch.zeros(8, 128) for _ in range(n)] for _ in range(4)]
    ptrs, lengths = fused_adam.check_leaves(*lists())
    assert len(ptrs) == 12 and lengths == [1024] * 3
    empty = lists()
    for x in empty:
        x[1] = torch.zeros(0, 128)
    assert fused_adam.check_leaves(*empty)[1] == [1024, 1024]
    misaligned = lists()
    misaligned[2][1] = torch.zeros(1025)[1:].reshape(8, 128)   # 4 bytes off
    mixed_type = lists()
    mixed_type[1][2] = torch.zeros(8, 128, dtype=torch.float64)
    mixed_shape = lists()
    mixed_shape[3][0] = torch.zeros(128, 8)
    strided = lists()
    strided[0][1] = torch.zeros(128, 8).t()
    mixed_device = lists()
    mixed_device[1][0] = torch.zeros(8, 128, device="meta")
    for bad in (misaligned, mixed_type, mixed_shape, strided, mixed_device):
        with pytest.raises(ValueError, match="16-byte aligned float32"):
            fused_adam.check_leaves(*bad)
    short = lists()
    short[3].pop()
    with pytest.raises(ValueError, match="one length"):
        fused_adam.check_leaves(*short)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_adam.adam_leaves(*([x.to("meta") for x in xs]
                                 for xs in lists()), 1e-3, 1.0, 0.9, 0.999,
                               1e-8)


def test_fused_adam_steps_its_kernel_leaves_in_one_call(monkeypatch):
    big, small, other = (nn.Parameter(torch.randn(*s))
                         for s in ((16, 128), (5,), (32, 128)))
    optimizer = FusedAdam([big, small, other], kernel_params=[big, other])
    calls = []
    real = fused_adam.adam_leaves

    def spy(params, *args):
        calls.append([id(p) for p in params])
        return real(params, *args)
    monkeypatch.setattr(fused_adam, "adam_leaves", spy)
    for p in (big, small, other):
        p.grad = torch.ones_like(p)
    optimizer.step()
    assert calls == [[id(big), id(other)]]
    assert float(optimizer.state[small]["step"]) == 1.0


def test_a_group_steps_under_one_count():
    """A parameter left without a gradient falls a count behind; the next
    step over both refuses rather than mixing bias corrections."""
    a, b = (nn.Parameter(torch.ones(4)) for _ in range(2))
    optimizer = FusedAdam([a, b], kernel_params=[])
    a.grad = torch.ones(4)
    optimizer.step()
    b.grad = torch.ones(4)
    with pytest.raises(ValueError, match="step counts differ"):
        optimizer.step()


def test_cpu_route_never_builds_and_other_devices_raise(monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU route reached cuda_build")
    monkeypatch.setattr(cuda_build, "load", no_build)
    fused_adam._library.cache_clear()
    p, g, m, v = (torch.ones(8, 128) for _ in range(4))
    before = fused_adam.adam_leaves.launches
    fused_adam.adam_leaf(p, g, m, v, 1e-3, 1.0, 0.9, 0.999, 1e-8)
    assert fused_adam.adam_leaves.launches == before
    np.testing.assert_allclose(m.numpy(), 1.0, rtol=1e-6)
    assert bool((p < 1).all())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_adam.adam_leaf(*(t.to("meta") for t in (p, g, m, v)),
                             1e-3, 1.0, 0.9, 0.999, 1e-8)


def test_cli_trains_saves_and_resumes_with_fused_adam(corpus):  # noqa: F811
    argv = _argv(corpus, "fused_adam", "--device", "cpu", "--eval_steps",
                 "100")    # no inline eval: the optimizer is under test
    argv[argv.index("--checkpoint_interval") + 1] = "1"
    argv[argv.index("--hparams") + 1] = HP_SPEC + ",use_fused_adam=True"
    _, step = cli.main(argv + ["--max_steps", "1"])
    assert step == 1
    path = corpus / "fused_adam" / "models" / "model.ckpt-1"
    ckpt = torch.load(path, weights_only=True)
    states = ckpt["optim"]["state"].values()
    assert all(sorted(s) == ["exp_avg", "exp_avg_sq", "step"] and
               float(s["step"]) == 1.0 for s in states)
    # the checkpoint restores under torch.optim.Adam too
    hp = default_config().parse(HP_SPEC)
    model = ByteToMel(hp, device="cpu")
    model.load_state_dict(ckpt["model"])
    adam, _ = make_optimizer(model, hp)
    adam.load_state_dict(ckpt["optim"])
    model, step = cli.main(argv + ["--max_steps", "2"])
    assert step == 2
    logs = "".join(p.read_text() for p in (
        corpus / "fused_adam" / "logs").glob("outputs_*.log"))
    assert "step 1" in logs and "[Step 2]" in logs
