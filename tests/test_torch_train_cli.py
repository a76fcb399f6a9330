"""The port's training CLI, ``python -m few_shot_transformer_tts_torch.train
--device cpu``, on a tiny synthetic corpus at small widths: it trains,
writes the reference-format checkpoint, the feeder state and the inline-eval
files, resumes where it stopped, and its checkpoint loads into the JAX
package's ``load_reference_checkpoint`` with equal parameters, batch
statistics and Adam moments (within 1e-6).  Without ``--device cpu`` and
with no card it raises."""

import io
import json
import logging
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.config import default_config as jax_cfg
from few_shot_transformer_tts_tpu.train.converter import \
    load_reference_checkpoint as jax_load_reference_checkpoint
from few_shot_transformer_tts_tpu.train.loop import \
    make_optimizer as jax_make_optimizer
from few_shot_transformer_tts_torch.train import cli
from few_shot_transformer_tts_torch.train.converter import \
    state_dict_from_jax_variables

ROOT = Path(__file__).resolve().parents[1]
HP_SPEC = ("vocab_size=300,embed_size=32,encoder_hidden=32,decoder_hidden=48,"
           "n_encoder_layer=2,n_decoder_layer=2,n_attention_head=4,"
           "prenet_hidden=16,postnet_hidden=24,n_postnet_layer=3,num_mels=20,"
           "max_num_speaker=16,speaker_embedding_size=8,max_num_language=10,"
           "language_embedding_size=8,max_generation_frames=12,"
           "input_length_multiple=8,target_length_multiple=8,"
           "batch_size_multiple=2,use_bfloat16=False,bucket_size=16,"
           "data_warmup_steps=0,n_iter=4")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.RandomState(0)
    rows, spk_to_id, lang_to_id = [], {}, {}
    with zipfile.ZipFile(root / "mels.zip", "w") as zf:
        for lang in ["en-us", "de-de"]:
            lang_to_id[lang] = len(lang_to_id)
            spk = lang[:2] + "0"
            spk_to_id[spk] = len(spk_to_id)
            for i in range(12):
                name = "%s_%010d" % (spk, i)
                t = int(rng.randint(8, 30))
                buf = io.BytesIO()
                np.save(buf, np.clip(rng.randn(t, 20), -4, 4).astype(
                    np.float32))
                zf.writestr(name + ".npy", buf.getvalue())
                rows.append("%s.npy|%d|hello %d|%s" % (name, t, i, lang))
    (root / "metadata.train.txt").write_text("\n".join(rows))
    (root / "metadata.eval.txt").write_text("\n".join(rows[:2]))
    (root / "lang_id.json").write_text(json.dumps(lang_to_id))
    (root / "spk_id.json").write_text(json.dumps(spk_to_id))
    return root


@pytest.fixture(autouse=True)
def _keep_root_logger(monkeypatch):
    """The CLI replaces the root logger's handlers; restore them after."""
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)


def _argv(root, run, *extra):
    return ["--model-dir", str(root / run / "models"),
            "--log-dir", str(root / run / "logs"), "--data-dir", str(root),
            "--checkpoint_interval", "3", "--summary_interval", "2",
            "--log_interval", "2", "--hparams", HP_SPEC, *extra]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """5 steps with a checkpoint at 3 (the run the tests below read)."""
    handlers = list(logging.root.handlers)
    try:
        _, step = cli.main(_argv(corpus, "run", "--device", "cpu",
                                 "--max_steps", "5"))
    finally:
        logging.root.handlers = handlers
    assert step == 5
    return corpus / "run"


def test_cli_trains_and_writes_checkpoint_feeder_state_and_eval(trained):
    assert sorted(os.listdir(trained / "models")) == ["model.ckpt-3"]
    assert (trained / "logs" / "feeder_0.pkl").exists()
    assert any(f.endswith(".wav")
               for f in os.listdir(trained / "logs" / "eval_3"))
    logs = "".join(p.read_text() for p in (trained / "logs").glob(
        "outputs_*.log"))
    # every step gets its own line, emitted in bursts
    assert all("[Step %d]" % s in logs for s in range(1, 6))
    metrics = [json.loads(line) for line in
               (trained / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert {m["tag"] for m in metrics} >= {"losses/loss", "lr"}
    ckpt = torch.load(trained / "models" / "model.ckpt-3",
                      weights_only=True)
    assert sorted(ckpt) == ["model", "optim", "sched", "step"]
    assert ckpt["step"] == 3 and ckpt["sched"]["last_epoch"] == 3


def test_cli_resumes_at_the_checkpoint(corpus, trained):
    run = corpus / "resume"
    (run / "models").mkdir(parents=True)
    (run / "logs").mkdir()
    for src, dst in [(trained / "models" / "model.ckpt-3",
                      run / "models" / "model.ckpt-3"),
                     (trained / "logs" / "feeder_0.pkl",
                      run / "logs" / "feeder_0.pkl")]:
        dst.write_bytes(src.read_bytes())
    model, step = cli.main(_argv(corpus, "resume", "--device", "cpu",
                                 "--max_steps", "4"))
    assert step == 4
    logs = "".join(p.read_text() for p in (run / "logs").glob(
        "outputs_*.log"))
    assert "step 3" in logs and "[Step 4]" in logs and "[Step 3]" not in logs
    assert model.postnet.batchnorm_layers[0].num_batches_tracked.item() == 4


def test_checkpoint_loads_into_the_jax_package(trained):
    path = str(trained / "models" / "model.ckpt-3")
    hp = jax_cfg().parse(HP_SPEC)
    variables, opt_state, step = jax_load_reference_checkpoint(
        path, tx=jax_make_optimizer(hp))
    assert step == 3
    ckpt = torch.load(path, weights_only=True)
    port_sd = ckpt["model"]
    as_port = state_dict_from_jax_variables(
        jax.tree.map(np.asarray, variables))
    for name, t in as_port.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(t.numpy(), port_sd[name].numpy(),
                                   atol=1e-6, err_msg=name)
    assert any(name.endswith("running_var") for name in as_port)
    adam = opt_state[0]
    assert int(adam.count) == 3
    names = [k for k in port_sd
             if k.rsplit(".", 1)[-1] not in ("running_mean", "running_var",
                                             "num_batches_tracked")]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = state_dict_from_jax_variables(
            {"params": jax.tree.map(np.asarray, tree)})
        for i, name in enumerate(names):
            np.testing.assert_allclose(
                moments[name].numpy(),
                ckpt["optim"]["state"][i][key].numpy(), atol=1e-6,
                err_msg="%s %s" % (key, name))


def test_cli_restores_from_a_jax_msgpack_checkpoint(corpus, trained):
    """``--restore_from`` a JAX package msgpack train state holding the
    step-3 checkpoint's weights and Adam moments continues as
    ``--restore_from`` the torch checkpoint does: the same weights after
    step 4."""
    import flax.serialization
    torch_ckpt = trained / "models" / "model.ckpt-3"
    hp = jax_cfg().parse(HP_SPEC)
    variables, opt_state, step = jax_load_reference_checkpoint(
        str(torch_ckpt), tx=jax_make_optimizer(hp))
    adam, schedule = jax.device_get(opt_state)
    jax_ckpt = corpus / "jax_model.ckpt-3"
    jax_ckpt.write_bytes(flax.serialization.msgpack_serialize({
        "step": np.asarray(step, np.int32), "params": variables["params"],
        "opt_state": {"0": {"count": adam.count, "mu": adam.mu,
                            "nu": adam.nu},
                      "1": {"count": schedule.count}},
        "batch_stats": variables["batch_stats"]}))
    models = {}
    for run, path in (("from_torch", torch_ckpt), ("from_msgpack", jax_ckpt)):
        models[run], last = cli.main(_argv(
            corpus, run, "--device", "cpu", "--max_steps", "4",
            "--restore_from", str(path)))
        assert last == 4
    want = models["from_torch"].state_dict()
    got = models["from_msgpack"].state_dict()
    for name in want:
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[name], want[name], rtol=0,
                                       atol=0, msg=name)


def test_cli_needs_cuda_unless_asked_for_cpu(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(_argv(corpus, "nocard", "--max_steps", "1"))


def test_module_entry_point_runs_the_cli(corpus):
    """``python -m few_shot_transformer_tts_torch.train`` is the CLI."""
    proc = subprocess.run(
        [sys.executable, "-m", "few_shot_transformer_tts_torch.train",
         "--help"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--device" in proc.stdout and "--model-dir" in proc.stdout
