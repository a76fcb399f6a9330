"""The port's eval service (``few_shot_transformer_tts_torch/infer/
evalservice.py`` and its CLI ``python -m few_shot_transformer_tts_torch.eval``)
against the JAX package's: the checkpoint filter, the transcription cache,
the saver pool's kinds and start method, the CLI's options, and one pass of
both services over the msgpack checkpoints the JAX trainer writes (and a
sharded ``.d`` copy), decoding deterministically: the same files, mels to
1e-4 and DTW-MSE scalars to 1e-4 relative."""

import importlib.util
import io
import json
import logging
import os
import pickle
import signal
import zipfile
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_torch import eval as port_cli
from few_shot_transformer_tts_torch.infer import evalservice as port_eval
from few_shot_transformer_tts_torch.utils import infolog as port_infolog
from few_shot_transformer_tts_torch.utils import metrics as port_metrics
from few_shot_transformer_tts_tpu.config import default_config as jax_cfg
from few_shot_transformer_tts_tpu.infer import evalservice as jax_eval

ROOT = Path(__file__).resolve().parents[1]
# small_test_config, and the eval's frame cap and Griffin-Lim iterations
HP_SPEC = ("vocab_size=300,embed_size=32,encoder_hidden=32,decoder_hidden=48,"
           "n_encoder_layer=2,n_decoder_layer=2,n_attention_head=4,"
           "prenet_hidden=16,postnet_hidden=24,n_postnet_layer=3,num_mels=20,"
           "max_num_speaker=16,speaker_embedding_size=8,max_num_language=10,"
           "language_embedding_size=8,language_net_hidden=8,"
           "input_length_multiple=8,target_length_multiple=8,"
           "batch_size_multiple=2,use_bfloat16=False,"
           "use_pallas_attention=False,warmup_steps=2,bucket_size=16,"
           "data_warmup_steps=0,n_iter=2,max_generation_frames=12")


def _root_eval_cli():
    spec = importlib.util.spec_from_file_location("jax_eval_cli",
                                                  ROOT / "eval.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


@pytest.fixture(autouse=True)
def _keep_root_logger(monkeypatch):
    """Both services replace the root logger's handlers; restore them."""
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)


# ---------------------------------------------------------------------------
# checkpoint filter (reference eval.py:130-143)
# ---------------------------------------------------------------------------

STEPS = [5000, 10000, 15000, 20000, 25000, 30000, 40001]
FILTERS = [  # finished, start_step, eval_steps, eval_interval
    ([], 10000, None, 10000),
    ([], 50000, [5000, 25000], 10000),
    (["model.ckpt-10000"], 0, None, 10000),
    ([], 0, None, 5000),
    (["model.ckpt-20000.d"], 0, [20000, 40001], 10000),
    ([], 0, [], 10000)]


@pytest.mark.parametrize("finished,start,steps,interval", FILTERS)
def test_select_checkpoints_matches_jax(tmp_path, finished, start, steps,
                                        interval):
    paths = [str(tmp_path / ("model.ckpt-%d" % s)) for s in STEPS]
    for name in ("model.ckpt-20000.d", "model.ckpt-35000.d"):
        (tmp_path / name).mkdir()             # sharded dirs
        paths.append(str(tmp_path / name))
    (tmp_path / "model.ckpt-45000.d").write_text("")   # a file, not a dir
    paths += [str(tmp_path / n) for n in ("model.ckpt-45000.d",
                                          "model.ckpt-backup",
                                          "model.ckpt-tmp-1a")]
    paths = paths[::-1]
    finished = [str(tmp_path / f) for f in finished]
    got = port_eval.select_checkpoints(paths, finished, start, steps,
                                       interval)
    assert got == jax_eval.select_checkpoints(paths, finished, start, steps,
                                              interval)
    assert [s for _, s in got] == sorted(s for _, s in got)


# ---------------------------------------------------------------------------
# transcription cache (reference eval.py:27-59)
# ---------------------------------------------------------------------------


def _fake_transcription(name, lang="en-us", cer=0.25, ok=True):
    if ok:
        return {"name": name, "locale": lang, "cer": cer,
                "DisplayText": "text for %s" % name}
    return {"name": name, "locale": lang, "cer": 1.0, "DisplayText": "",
            "fail": True}


def test_run_transcription_merges_cache(tmp_path, monkeypatch):
    eval_path = str(tmp_path)
    # 'kept' succeeded before and is not requested again; 'stale' failed
    # before (empty DisplayText) so it is transcribed again
    with open(os.path.join(eval_path, "transcriptions.jsonl"), "w") as f:
        for t in (_fake_transcription("kept", cer=0.5),
                  _fake_transcription("stale", ok=False)):
            f.write(json.dumps(t) + "\n")
    called = []

    def fake_transcribe(wav_path, meta, id_to_lang):
        name = meta["n"][:-4]
        called.append(name)
        assert wav_path == os.path.join(eval_path, name + "_trim.wav")
        assert id_to_lang("en_us") == "en-us"
        return _fake_transcription(name, ok=(name != "bad"))

    monkeypatch.setattr(port_metrics, "transcribe", fake_transcribe)
    meta_index = {n + ".npy": {"n": n + ".npy", "t": "x", "i": "en_us"}
                  for n in ["new", "bad", "stale", "kept"]}
    window = port_infolog.LookupWindow("cer", reduction="avg")
    port_eval.run_transcription(
        eval_path, names=["new", "bad"], existent_samples=["kept", "stale"],
        meta_index=meta_index, cer_window=window, step=7)
    assert sorted(called) == ["bad", "new", "stale"]
    with open(os.path.join(eval_path, "transcriptions.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [t["name"] for t in lines] == ["bad", "kept", "new", "stale"]
    by_name = {t["name"]: t for t in lines}
    assert by_name["kept"]["cer"] == 0.5
    assert by_name["bad"].get("fail")
    # the cached 'kept' counts, the failed 'bad' does not
    summary = dict(window.summary())
    assert summary["cer/en-us"] == pytest.approx((0.5 + 0.25 + 0.25) / 3)


def test_run_transcription_no_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(
        port_metrics, "transcribe",
        lambda wav_path, meta, id_to_lang: _fake_transcription(meta["n"][:-4]))
    meta_index = {"a.npy": {"n": "a.npy", "t": "x", "i": "en_us"}}
    window = port_infolog.LookupWindow("cer", reduction="avg")
    port_eval.run_transcription(
        str(tmp_path), names=["a", "unknown"], existent_samples=[],
        meta_index=meta_index, cer_window=window, step=1)
    with open(tmp_path / "transcriptions.jsonl") as f:
        lines = [json.loads(line) for line in f]
    # 'unknown' has no metadata row: skipped (reference eval.py:47)
    assert [t["name"] for t in lines] == ["a"]
    assert dict(window.summary()) == {"cer/en-us": 0.25}


# ---------------------------------------------------------------------------
# saver pool
# ---------------------------------------------------------------------------


def _child_report(x):
    """Run in a pool worker: numpy in, numpy out, and whether importing the
    port's synthesis module started CUDA there."""
    import torch as child_torch
    from few_shot_transformer_tts_torch.infer import synthesize  # noqa: F401
    return float(np.sum(x)), child_torch.cuda.is_initialized()


@pytest.mark.parametrize("kind,cuda_started,want", [
    ("thread", False, "thread"), ("thread", True, "thread"),
    (None, False, "fork"), ("process", False, "fork"),
    (None, True, "spawn")])
def test_make_saver_pool_kinds(kind, cuda_started, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_started)
    pool = port_eval.make_saver_pool(kind, workers=2)
    try:
        assert isinstance(pool, ThreadPoolExecutor if want == "thread"
                          else ProcessPoolExecutor)
        assert port_eval.saver_pool_kind(pool) == want
        if want == "spawn":   # a fresh interpreter runs the work
            total, cuda = pool.submit(_child_report,
                                      np.arange(4.0)).result(timeout=240)
            assert total == 6.0 and cuda is False
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_parser_accepts_every_option_of_the_root_eval_cli():
    root = _root_eval_cli().build_parser()
    port = port_cli.build_parser()
    port_opts = {o: a for a in port._actions for o in a.option_strings}
    for action in root._actions:
        for opt in action.option_strings:
            if opt == "--tpu_vocoder":
                opt = "--gpu_vocoder"         # the card's counterpart
            assert opt in port_opts, opt
            assert port_opts[opt].default == action.default, opt
    required = ["--model-dir", "m", "--log-dir", "l", "--data-dir", "d"]
    argv = required + ["--no_wait", "false", "--recover_eval",
                       "--start_step", "3", "--eval_steps", "1:2",
                       "--saver_pool", "thread", "--hparams", "n_iter=2"]
    want = vars(root.parse_args(argv))
    got = vars(port.parse_args(argv + ["--gpu_vocoder"]))
    assert got.pop("gpu_vocoder") is True and got.pop("device") == "cuda"
    assert want.pop("tpu_vocoder") is False
    assert got == want
    for v in ("1", "yes", "False", "n", ""):
        assert port_cli.str2bool(v) == _root_eval_cli().str2bool(v)


def test_cli_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--model-dir", str(tmp_path), "--log-dir",
                       str(tmp_path / "logs"), "--data-dir", str(tmp_path),
                       "--no_wait"])
    assert not (tmp_path / "logs").exists()


# ---------------------------------------------------------------------------
# end to end: the JAX trainer's checkpoints through both services
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """2 JAX training steps with a msgpack checkpoint after each; step 2
    with its stop bias at -1e4 (every row decodes to the frame cap; an
    untrained stop head fires at once) as a msgpack checkpoint at step 3;
    and a two-rank sharded copy of step 2 at step 4 (the layout of
    tests/test_evalservice.py)."""
    from few_shot_transformer_tts_tpu.models.tacotron import ByteToMel
    from few_shot_transformer_tts_tpu.train import checkpoint as jax_ckpt
    from few_shot_transformer_tts_tpu.train.loop import create_state, train

    root = str(tmp_path_factory.mktemp("run"))
    hp = jax_cfg().parse(HP_SPEC)
    rng = np.random.RandomState(0)
    rows, spk_to_id, lang_to_id = [], {}, {}
    with zipfile.ZipFile(os.path.join(root, "mels.zip"), "w") as zf:
        for lang in ["en-us", "de-de"]:
            lang_to_id.setdefault(lang, len(lang_to_id))
            spk = lang[:2] + "0"
            spk_to_id.setdefault(spk, len(spk_to_id))
            for i in range(8):
                name = "%s_%010d" % (spk, i)
                t = int(rng.randint(10, 24))
                buf = io.BytesIO()
                np.save(buf, rng.randn(t, hp.num_mels).astype(np.float32))
                zf.writestr(name + ".npy", buf.getvalue())
                rows.append("%s.npy|%d|hello %d|%s" % (name, t, i, lang))
    with open(os.path.join(root, "metadata.train.txt"), "w") as f:
        f.write("\n".join(rows))
    with open(os.path.join(root, "metadata.eval.txt"), "w") as f:
        f.write("\n".join(rows[:3] + rows[8:11]))
    with open(os.path.join(root, "lang_id.json"), "w") as f:
        json.dump(lang_to_id, f)
    with open(os.path.join(root, "spk_id.json"), "w") as f:
        json.dump(spk_to_id, f)

    class Args:
        model_dir = os.path.join(root, "models")
        log_dir = os.path.join(root, "logs")
        data_dir = root
        zipfilepath = None
        train_meta = None
        eval_meta = None
        adapt_languages = adapt_speakers = training_languages = None
        training_speakers = eval_languages = eval_speakers = None
        warmup_languages = warmup_speakers = exclude_speakers = None
        adapt_samples = downsample_languages = None
        eval_steps = "-1"  # no inline eval
        checkpoint_interval = 1
        summary_interval = 10
        restore_from = None
        multihost = False
        max_steps = 2
        seed = 0

    handler = signal.getsignal(signal.SIGTERM)
    try:
        train(Args(), hp)
    finally:   # the trainer installs its own SIGTERM handler
        signal.signal(signal.SIGTERM, handler)

    # step 2 again as a two-rank .d dir at step 4
    b = 2
    template = create_state(ByteToMel(hp), hp, 0, {
        "inputs": np.full((b, 8), 3, np.int32),
        "input_lengths": np.full((b,), 8, np.int32),
        "mel_targets": np.zeros((b, 8, hp.num_mels), np.float32),
        "target_lengths": np.full((b,), 8, np.int32),
        "input_spk_ids": np.zeros((b,), np.int32),
        "input_language_vecs": np.eye(hp.max_num_language,
                                      dtype=np.float32)[:b]})
    state = jax_ckpt.load_state(os.path.join(Args.model_dir, "model.ckpt-2"),
                                template)
    params = jax.tree.map(np.asarray, state.params)
    params["decoder"]["stop_net"]["bias"] = np.full_like(
        params["decoder"]["stop_net"]["bias"], -1e4)
    jax_ckpt.save_state(Args.model_dir, state.replace(
        step=state.step * 0 + 3, params=params), 3)
    state = state.replace(step=state.step * 0 + 4)
    flat = jax_ckpt._flatten_state(state)
    keys = sorted(flat)
    ckpt_dir = os.path.join(Args.model_dir, "model.ckpt-4.d")
    os.makedirs(ckpt_dir)
    for rank in range(2):
        leaves = {}
        for key in keys[rank::2]:
            arr = np.asarray(flat[key])
            leaves[key] = {"shape": arr.shape, "dtype": str(arr.dtype),
                           "shards": [(tuple(slice(None)
                                             for _ in arr.shape), arr)]}
        with open(os.path.join(ckpt_dir, "shard-%d-of-2.pkl" % rank),
                  "wb") as f:
            pickle.dump({"rank": rank, "world": 2, "step": 4,
                         "leaves": leaves}, f, protocol=4)
    return root


def _deterministic(module, monkeypatch):
    """The service's decode with dropout off, so both sides agree."""
    synthesize = module.synthesize_batch

    def fixed(*args, **kwargs):
        kwargs["deterministic"] = True
        return synthesize(*args, **kwargs)
    monkeypatch.setattr(module, "synthesize_batch", fixed)


def _argv(root, log_dir):
    return ["--model-dir", os.path.join(root, "models"), "--log-dir",
            log_dir, "--data-dir", root, "--no_wait", "--start_step", "0",
            "--eval_interval", "1", "--scan_interval", "1",
            "--hparams", HP_SPEC]


@pytest.fixture
def no_retry(monkeypatch):
    """A checkpoint that fails to load fails the test at once, instead of
    being retried for ten minutes."""
    def sleep(seconds):
        raise AssertionError("the service waited %s s: a checkpoint did "
                             "not load" % seconds)
    monkeypatch.setattr(port_eval.time, "sleep", sleep)


def _scalars(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return {(m["tag"], m["step"]): m["value"] for m in map(json.loads, f)}


def test_port_and_jax_eval_agree_on_the_jax_trainers_checkpoints(
        trained_run, tmp_path, monkeypatch, no_retry):
    root = trained_run
    jax_logs, port_logs = str(tmp_path / "jax"), str(tmp_path / "port")

    _deterministic(jax_eval, monkeypatch)
    jax_args = _root_eval_cli().build_parser().parse_args(_argv(root,
                                                                jax_logs))
    jax_eval.main(jax_args, jax_cfg().parse(HP_SPEC))

    _deterministic(port_eval, monkeypatch)
    records = port_cli.main(_argv(root, port_logs) + ["--device", "cpu"])
    assert [(r["step"], r["format"]) for r in records] == \
        [(1, "msgpack"), (2, "msgpack"), (3, "msgpack"), (4, "sharded")]
    assert {r["pool"] for r in records} == {"fork"}
    assert all(r["samples"] == 6 for r in records)

    for step in (1, 2, 3, 4):
        sub = "eval_%d" % step
        got_files = sorted(os.listdir(os.path.join(port_logs, sub)))
        assert got_files == sorted(os.listdir(os.path.join(jax_logs, sub)))
        names = [f[:-4] for f in got_files if f.endswith(".npy")]
        assert len(names) == 6
        for name in names:
            for ext in (".wav", "_trim.wav"):
                assert name + ext in got_files
            got = np.load(os.path.join(port_logs, sub, name + ".npy"))
            want = np.load(os.path.join(jax_logs, sub, name + ".npy"))
            assert got.shape == want.shape
            assert step != 3 or got.shape == (12, 20)    # to the cap
            np.testing.assert_allclose(got, want, atol=1e-4,
                                       err_msg="%s %s" % (sub, name))
    # the .d copy holds step 2's weights
    for name in names:
        np.testing.assert_array_equal(
            np.load(os.path.join(port_logs, "eval_4", name + ".npy")),
            np.load(os.path.join(port_logs, "eval_2", name + ".npy")))

    got, want = _scalars(port_logs), _scalars(jax_logs)
    assert sorted(got) == sorted(want)
    assert {tag for tag, _ in got} == {"mse_dtw/en-us", "mse_dtw/de-de"}
    for key in want:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=str(key))


def test_recover_eval_skips_existing_samples(trained_run, tmp_path,
                                             no_retry):
    """A second pass with --recover_eval synthesizes only the samples
    without a _trim.wav."""
    root, log_dir = trained_run, str(tmp_path / "logs")
    argv = _argv(root, log_dir) + [
        "--device", "cpu", "--eval_steps", "2", "--saver_pool", "thread"]
    (first,) = port_cli.main(argv)
    assert first["samples"] == 6 and first["pool"] == "thread"
    eval_dir = os.path.join(log_dir, "eval_2")
    gone = sorted(f for f in os.listdir(eval_dir)
                  if f.endswith("_trim.wav"))[:2]
    for f in gone:
        os.remove(os.path.join(eval_dir, f))
    (second,) = port_cli.main(argv + ["--recover_eval"])
    assert second["samples"] == 2
    assert sorted(f for f in os.listdir(eval_dir)
                  if f.endswith("_trim.wav"))[:2] == gone


def test_half_written_sharded_dir_is_retried_then_given_up(
        trained_run, tmp_path, monkeypatch):
    """A .d dir that never loads is retried on a short cadence for ~10
    minutes (no real sleeping here), then given up without blocking the
    checkpoints after it."""
    root = trained_run
    models = tmp_path / "models"
    models.mkdir()
    (models / "model.ckpt-1.d").mkdir()         # no shard file ever lands
    src = os.path.join(root, "models", "model.ckpt-2")
    (models / "model.ckpt-2").write_bytes(Path(src).read_bytes())
    sleeps = []
    monkeypatch.setattr(port_eval.time, "sleep", sleeps.append)
    argv = ["--model-dir", str(models), "--log-dir", str(tmp_path / "logs"),
            "--data-dir", root, "--no_wait", "--start_step", "0",
            "--eval_interval", "1", "--scan_interval", "30", "--device",
            "cpu", "--saver_pool", "thread", "--hparams", HP_SPEC]
    records = port_cli.main(argv)
    assert sleeps == [30] * 19       # 20 tries of the .d dir, 30 s apart
    assert [r["step"] for r in records] == [2]
    assert not os.path.exists(tmp_path / "logs" / "eval_1")
