"""One reference-format checkpoint through both synthesis CLIs: the port's
``python -m few_shot_transformer_tts_torch.synthesize --device cpu`` and the
JAX package's root ``synthesize.py`` (both in-process, deterministic, fp32).
The saved ``.npy`` mels must agree at 1e-4.  The port's CLI also reads the
JAX package's msgpack checkpoint of the same weights, to the same mels."""

import importlib.util
import json
import logging
import os
import sys
from pathlib import Path

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_torch import synthesize as port_cli
from few_shot_transformer_tts_torch.train.converter import \
    state_dict_from_jax_variables

from test_torch_weights import jax_variables

ROOT = Path(__file__).resolve().parents[1]
HP_SPEC = ("vocab_size=300,embed_size=32,encoder_hidden=32,decoder_hidden=48,"
           "n_encoder_layer=2,n_decoder_layer=2,n_attention_head=4,"
           "prenet_hidden=16,postnet_hidden=24,n_postnet_layer=3,num_mels=20,"
           "max_num_speaker=16,speaker_embedding_size=8,max_num_language=10,"
           "language_embedding_size=8,language_net_hidden=8,n_iter=2,"
           "max_generation_frames=12,input_length_multiple=8,"
           "target_length_multiple=8,batch_size_multiple=2,"
           "use_bfloat16=False,use_pallas_attention=False")
NAMES = ("spk0_0", "spk1_0", "spk0_1")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    (root / "lang_id.json").write_text(json.dumps({"en-us": 0, "de-de": 1}))
    (root / "spk_id.json").write_text(json.dumps({"spk0": 0, "spk1": 1}))
    (root / "script.txt").write_text(
        "spk0_0|50|hello world|en-us\nspk1_0|50|hallo welt|de-de\n"
        "spk0_1|50|a longer line of text|en-us\n", encoding="utf-8")
    variables = jax_variables(21)
    # stop logits far below 0: every line decodes to the frame cap
    variables["params"]["decoder"]["stop_net"]["bias"] = \
        np.asarray([-1e4], np.float32)
    sd = state_dict_from_jax_variables(variables)
    ckpt = root / "model.ckpt-3"
    torch.save({"model": sd, "optim": {}, "sched": {"last_epoch": 3},
                "step": 3}, str(ckpt))
    return root, ckpt


def _args(root, ckpt, out):
    return ["--checkpoint", str(ckpt), "--script", str(root / "script.txt"),
            "--data-dir", str(root), "--output-dir", str(out),
            "--hparams", HP_SPEC, "--deterministic"]


def _run_jax_cli(argv, monkeypatch, cache_dir):
    spec = importlib.util.spec_from_file_location("jax_synthesize_cli",
                                                  ROOT / "synthesize.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(cache_dir))
    monkeypatch.setattr(sys, "argv", ["synthesize.py"] + argv)
    previous = jax.config.jax_compilation_cache_dir
    try:
        cli.main()
    finally:  # the CLI points the process-wide cache at cache_dir
        jax.config.update("jax_compilation_cache_dir", previous)


@pytest.fixture(autouse=True)
def _keep_root_logger(monkeypatch):
    """Both CLIs replace the root logger's handlers; restore them after."""
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)


def test_port_and_jax_cli_agree_on_one_checkpoint(setup, tmp_path,
                                                  monkeypatch):
    root, ckpt = setup
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    port_cli.main(_args(root, ckpt, port_out) + ["--device", "cpu"])
    _run_jax_cli(_args(root, ckpt, jax_out), monkeypatch, tmp_path / "jc")
    for name in NAMES:
        got = np.load(port_out / (name + ".npy"))
        want = np.load(jax_out / (name + ".npy"))
        assert got.shape == want.shape == (12, 20)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        for suffix in (".wav", "_trim.wav", "_mel.png", "_align.png"):
            assert os.path.exists(port_out / (name + suffix)), name + suffix


def test_port_cli_needs_cuda_unless_asked_for_cpu(setup, tmp_path):
    root, ckpt = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(_args(root, ckpt, tmp_path / "out"))


def test_port_cli_rejects_other_checkpoint_formats(setup, tmp_path):
    root, _ = setup
    bogus = tmp_path / "model.ckpt-1"
    bogus.write_bytes(b"\x93params")              # a msgpack array
    with pytest.raises(ValueError, match="a torch file, a flax msgpack "
                       "file or a sharded .d directory"):
        port_cli.main(_args(root, bogus, tmp_path / "out") +
                      ["--device", "cpu"])


def test_port_cli_reads_a_jax_msgpack_checkpoint(setup, tmp_path):
    """The same weights as the JAX package's msgpack train state (flax
    ``to_bytes`` layout: step, params, Adam and schedule state,
    batch_stats) give the torch checkpoint's mels."""
    root, ckpt = setup
    variables = jax_variables(21)
    variables["params"]["decoder"]["stop_net"]["bias"] = \
        np.asarray([-1e4], np.float32)
    zeros = jax.tree.map(np.zeros_like, variables["params"])
    count = np.asarray(3, np.int32)
    msgpack_ckpt = tmp_path / "model.ckpt-3"
    msgpack_ckpt.write_bytes(flax.serialization.msgpack_serialize({
        "step": count, "params": variables["params"],
        "opt_state": {"0": {"count": count, "mu": zeros, "nu": zeros},
                      "1": {"count": count}},
        "batch_stats": variables["batch_stats"]}))
    torch_out, msgpack_out = tmp_path / "torch", tmp_path / "msgpack"
    port_cli.main(_args(root, ckpt, torch_out) + ["--device", "cpu"])
    port_cli.main(_args(root, msgpack_ckpt, msgpack_out) +
                  ["--device", "cpu"])
    for name in NAMES:
        got = np.load(msgpack_out / (name + ".npy"))
        want = np.load(torch_out / (name + ".npy"))
        assert got.shape == want.shape == (12, 20)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
