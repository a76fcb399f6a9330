"""The port's training Feeder and zip-reading FeederEval against the JAX
package's on one tiny synthetic corpus (the template of
tests/test_train.py's CLI test): the same options give the same batches,
array for array, and a restored state dict resumes at the same next batch.
These are copies of host code, so the results must be equal."""

import io
import zipfile

import numpy as np
import pytest

from few_shot_transformer_tts_tpu.config import default_config as jax_cfg
from few_shot_transformer_tts_tpu.data import Feeder as JaxFeeder
from few_shot_transformer_tts_tpu.data import FeederEval as JaxFeederEval
from few_shot_transformer_tts_tpu.data import metadata as jax_metadata
from few_shot_transformer_tts_torch.config import default_config
from few_shot_transformer_tts_torch.data import Feeder, FeederEval, metadata
from few_shot_transformer_tts_torch.data.zipstore import load_zip

LANGS = ["en-us", "de-de", "fr-fr"]
HP = dict(bucket_size=12, data_warmup_steps=0, batch_frame_limit=120,
          batch_frame_quad_limit=4000, num_mels=20)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """mels.zip + metadata: 3 languages x 2 speakers x 8 utterances."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    rows, spk_to_id, lang_to_id = [], {}, {}
    with zipfile.ZipFile(root / "mels.zip", "w") as zf:
        for lang in LANGS:
            lang_to_id[lang] = len(lang_to_id)
            for s in range(2):
                spk = "%s%d" % (lang[:2], s)
                spk_to_id[spk] = len(spk_to_id)
                for i in range(8):
                    name = "%s_%010d" % (spk, i)
                    t = int(rng.randint(8, 30))
                    buf = io.BytesIO()
                    np.save(buf, rng.randn(t, 20).astype(np.float32))
                    zf.writestr(name + ".npy", buf.getvalue())
                    rows.append("%s.npy|%d|hello %d %s|%s" % (name, t, i,
                                                             spk, lang))
    (root / "metadata.train.txt").write_text("\n".join(rows))
    (root / "metadata.eval.txt").write_text("\n".join(rows[::5]))
    return dict(zip=str(root / "mels.zip"),
                train=str(root / "metadata.train.txt"),
                eval=str(root / "metadata.eval.txt"),
                spk_to_id=spk_to_id, lang_to_id=lang_to_id)


def _batches(feeder, n):
    """The first ``n`` batches, produced on this thread (no producer
    thread is started)."""
    while feeder.queue.qsize() < n:
        feeder._enqueue_next_group()
    return [feeder.queue.get_nowait() for _ in range(n)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key


OPTIONS = {
    "default": ({}, {}, 1),
    "sequential_exclude": (dict(balanced_training=False),
                           dict(exclude_spk=["de1"]), 1),
    "adapt_warmup_downsample": (
        dict(data_warmup_steps=100, target_length_lower_bound=10,
             target_length_upper_bound=26, adapt_start_step=0,
             adapt_end_step=10, final_adapt_rate=0.5),
        dict(train_lang=["en-us", "de-de"], adapt_lang=["fr-fr"],
             downsample_lang={"de-de": 0.5}, warmup_lang=["en-us", "fr-fr"]),
        5),
}


def _pair(corpus, name, rank=0):
    hp_kw, kw, step = OPTIONS[name]
    feeders = []
    for cls, cfg in ((Feeder, default_config), (JaxFeeder, jax_cfg)):
        f = cls(corpus["zip"], corpus["train"], cfg(**{**HP, **hp_kw}),
                spk_to_id=corpus["spk_to_id"],
                lang_to_id=corpus["lang_to_id"], rank=rank, **kw)
        f.global_step = step
        feeders.append(f)
    return feeders


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_feeder_batches_match_jax(corpus, name):
    port, ref = _pair(corpus, name)
    got, want = _batches(port, 8), _batches(ref, 8)
    _assert_same_batches(got, want)
    for b in got:
        # lattice: T_in, T_out and B rounded up; padded rows have length 0
        assert b["inputs"].shape[1] % 32 == 0
        assert b["mel_targets"].shape[1] % 64 == 0
        assert b["inputs"].shape[0] % 8 == 0
        assert (b["target_lengths"][b["num_valid"]:] == 0).all()


def test_feeder_resumes_from_its_state_dict(corpus):
    port, _ = _pair(corpus, "adapt_warmup_downsample")
    _batches(port, 3)
    state = port.state_dict()
    pending = port.queue.qsize()
    after = _batches(port, pending + 4)[pending:]
    resumed, _ = _pair(corpus, "adapt_warmup_downsample")
    resumed.load_state_dict(state)
    _assert_same_batches(_batches(resumed, 4), after)


def test_feeder_ranks_draw_distinct_streams(corpus):
    a, _ = _pair(corpus, "default", rank=0)
    b, _ = _pair(corpus, "default", rank=1)
    names = lambda f: [n for x in _batches(f, 4) for n in x["names"]]
    assert names(a) != names(b)


def test_feeder_eval_reads_mels_from_the_zip_as_jax(corpus):
    kw = dict(spk_to_id=corpus["spk_to_id"], lang_to_id=corpus["lang_to_id"],
              shuffle=True, keep_order=True, pick_partial=True)
    port = FeederEval(corpus["zip"], corpus["eval"], default_config(**HP),
                      **kw)
    ref = JaxFeederEval(corpus["zip"], corpus["eval"], jax_cfg(**HP), **kw)
    got, want = port.fetch_data(), ref.fetch_data()
    assert got and all("mel_targets" in b for b in got)
    _assert_same_batches(got, want)


def test_zipstore_and_metadata_helpers_match_jax(corpus):
    store = load_zip(corpus["zip"])
    assert load_zip(corpus["zip"]) is store
    name = store.namelist()[3]
    np.testing.assert_array_equal(
        store.read_npy(name),
        np.load(io.BytesIO(zipfile.ZipFile(corpus["zip"]).read(name))))
    with open(corpus["train"], encoding="utf-8") as f:
        rows = metadata.read_meta(f, "nlti")
    for spec in ["", "de-de:0.5", "en-us:3,fr-fr:0.25"]:
        parsed = metadata.parse_downsample_spec(spec)
        assert parsed == jax_metadata.parse_downsample_spec(spec)
        assert metadata.downsample_language(rows, parsed) == \
            jax_metadata.downsample_language(rows, parsed)
    got = metadata.group_meta(rows, default_config())
    want = jax_metadata.group_meta(rows, jax_cfg())
    np.testing.assert_array_equal(got.pop("prob"), want.pop("prob"))
    assert got == want
