"""Weight bridge of the PyTorch port: JAX variables <-> port state dict,
reference checkpoints, strict loading.

Also holds the helpers the other ``test_torch_*`` files share: a JAX variable
tree made from a numpy seed and the port model that holds the same weights.
"""

import jax
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_tpu.models import ByteToMel as JaxByteToMel
from few_shot_transformer_tts_tpu.train.converter import \
    convert_torch_state_dict
from few_shot_transformer_tts_torch.config import Config, small_test_config
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.train.converter import (
    load_reference_checkpoint, state_dict_from_jax_variables)

NO_CONDITIONING = dict(multi_speaker=False, multi_lingual=False,
                       decoder_hidden=32)


def example_batch(hp, b=2, t_in=10, t_out=12, seed=0):
    """A numpy teacher-forcing batch for ``hp`` from a seed."""
    rng = np.random.RandomState(seed)
    return dict(
        inputs=rng.randint(3, 255, (b, t_in)).astype(np.int32),
        input_lengths=np.asarray([t_in, t_in - 3][:b], np.int32),
        mel_targets=rng.randn(b, t_out, hp.num_mels).astype(np.float32),
        target_lengths=np.asarray([t_out, t_out - 3][:b], np.int32),
        input_spk_ids=np.arange(b, dtype=np.int32),
        input_language_vecs=np.eye(hp.max_num_language,
                                   dtype=np.float32)[:b],
    )


def jax_variables(seed=0, **overrides):
    """A JAX ``{'params', 'batch_stats'}`` tree (numpy leaves) for
    ``small_test_config(**overrides)``: weights from the numpy seed, postnet
    running statistics random and non-trivial.  Built through the JAX
    package's own converter, so no JAX init has to be traced."""
    port = init_weights_(ByteToMel(small_test_config(**overrides),
                                   device="cpu"), seed)
    variables = convert_torch_state_dict(port.state_dict())
    rng = np.random.RandomState(seed + 1)
    for stats in variables["batch_stats"]["postnet"].values():
        n = stats["mean"].shape
        stats["mean"] = (0.3 * rng.randn(*n)).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return variables


def port_model(variables, **overrides):
    """The port's eval-mode model holding ``variables``."""
    model = ByteToMel(small_test_config(**overrides), device="cpu")
    model.load_state_dict(state_dict_from_jax_variables(variables),
                          strict=True)
    return model.eval()


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.mark.parametrize("overrides", [{}, NO_CONDITIONING],
                         ids=["conditioned", "unconditioned"])
def test_jax_init_tree_round_trips_through_port(overrides):
    """JAX init -> port (strict) -> the JAX converter gives back the same
    paths and values."""
    hp = jax_cfg(**overrides)
    model = JaxByteToMel(hp)
    batch = example_batch(hp)
    if not hp.multi_speaker:
        batch.pop("input_spk_ids")
    if not hp.multi_lingual:
        batch.pop("input_language_vecs")
    init = jax.jit(lambda key, b: model.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1)}, **b,
        train=True))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), batch))

    port = port_model(variables, **overrides)
    back = convert_torch_state_dict(port.state_dict())
    for col in ("params", "batch_stats"):
        want, got = _flat(variables[col]), _flat(back[col])
        assert sorted(want) == sorted(got), col
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg="/".join(path))


@pytest.mark.parametrize("overrides", [{}, NO_CONDITIONING],
                         ids=["conditioned", "unconditioned"])
def test_state_dict_round_trips_strict(overrides):
    """port state dict -> JAX tree -> port state dict is the identity, and
    loads strictly (num_batches_tracked included)."""
    variables = jax_variables(3, **overrides)
    port = port_model(variables, **overrides)
    sd = port.state_dict()
    again = state_dict_from_jax_variables(convert_torch_state_dict(sd))
    assert sorted(again) == sorted(sd)
    for name in sd:
        assert again[name].shape == sd[name].shape, name
        torch.testing.assert_close(again[name], sd[name], rtol=0, atol=0)
    assert sd["encoder.encoder.pe_scale"].shape == (1,)
    assert "postnet.batchnorm_layers.0.num_batches_tracked" in sd
    if overrides:
        assert not any(k.startswith("encoder.speaker") for k in sd)


def test_reference_names_and_layouts():
    variables = jax_variables(0)
    sd = port_model(variables).state_dict()
    hp = small_test_config()
    qkv = sd["encoder.encoder.self_attentions.0.qkv_transform.weight"]
    assert qkv.shape == (3 * hp.encoder_hidden, hp.embed_size)
    kv = sd["decoder.decoder.encdec_attentions.1.kv_transform.weight"]
    assert kv.shape == (2 * hp.decoder_hidden, hp.decoder_hidden)
    conv = sd["postnet.conv_layers.0.weight"]
    assert conv.shape == (hp.postnet_hidden, hp.num_mels, 5)
    np.testing.assert_array_equal(
        conv.numpy(),
        variables["params"]["postnet"]["conv_layers_0"]["kernel"]
        .transpose(2, 1, 0))
    assert "postnet.conv_layers.0.bias" not in sd
    np.testing.assert_array_equal(
        sd["postnet.batchnorm_layers.2.running_var"].numpy(),
        variables["batch_stats"]["postnet"]["batchnorm_layers_2"]["var"])


def test_load_reference_checkpoint(tmp_path):
    """A reference-format file with DataParallel prefixes and a one-element
    pe_scale of any shape loads strictly and returns its step."""
    variables = jax_variables(5)
    sd = state_dict_from_jax_variables(variables)
    ref = {"module." + k: v for k, v in sd.items()}
    ref["module.encoder.encoder.pe_scale"] = torch.tensor(1.25)
    path = str(tmp_path / "model.ckpt-7")
    torch.save({"model": ref, "optim": {}, "sched": {"last_epoch": 7},
                "step": 7}, path)
    model = ByteToMel(small_test_config(), device="cpu")
    assert load_reference_checkpoint(path, model) == 7
    assert model.encoder.encoder.pe_scale.item() == 1.25
    torch.testing.assert_close(model.state_dict()["decoder.mel_net.weight"],
                               sd["decoder.mel_net.weight"])
    del ref["module.decoder.stop_net.bias"]
    torch.save({"model": ref, "step": 8}, path)
    with pytest.raises(RuntimeError, match="stop_net.bias"):
        load_reference_checkpoint(path, model)


def test_external_embed_is_rejected():
    with pytest.raises(ValueError, match="use_external_embed"):
        small_test_config(use_external_embed=True)
    with pytest.raises(ValueError, match="use_external_embed"):
        small_test_config().parse("use_external_embed=True")


def test_hparams_strings_carry_over():
    spec = ("num_mels=40,use_bfloat16=False,max_generation_frames=64,"
            "n_attention_head=2,data_format=nltpi")
    want = jax_cfg().parse(spec).values()
    got = small_test_config().parse(spec).values()
    # the port's own fields beyond the JAX package's are the architecture
    # selector and F5-TTS's, at their defaults
    port_only = {k: got.pop(k) for k in set(got) - set(want)}
    assert got == want
    assert port_only["model"] == "byte2speech"
    defaults = Config().values()
    assert port_only == {k: defaults[k] for k in port_only}
    assert all(k == "model" or k.startswith(("dit_", "text_", "flow_"))
               for k in port_only)
