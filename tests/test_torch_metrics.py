"""The port's eval metrics (``few_shot_transformer_tts_torch/utils/
metrics.py``) against the JAX package's on the same seeded inputs: DTW path
and DTW-MSE (floats to 1e-12), Levenshtein, text normalization and CER, and
the Azure client, whose HTTP call is replaced by a fake (no test reaches
the network)."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from few_shot_transformer_tts_torch.utils import metrics as port
from few_shot_transformer_tts_tpu.utils import metrics as ref


def _mels(rng, t, d=20, unvoiced=()):
    mel = rng.randn(t, d)
    for i in unvoiced:
        mel[i] = -np.abs(mel[i]) - 0.1     # max <= 0: dropped by DTW-MSE
    return mel


@pytest.mark.parametrize("tx,ty", [(1, 1), (7, 5), (13, 29), (40, 40)])
def test_dtw_path_matches_jax(tx, ty):
    rng = np.random.RandomState(tx * 100 + ty)
    x, y = rng.randn(tx, 20), rng.randn(ty, 20)
    dist, path = port.dtw_path(x, y)
    want_dist, want_path = ref.dtw_path(x, y)
    assert path == want_path
    assert path[0] == (0, 0) and path[-1] == (tx - 1, ty - 1)
    np.testing.assert_allclose(dist, want_dist, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_calculate_mse_dtw_matches_jax(dtype):
    rng = np.random.RandomState(5)
    b, t_pred, t_tgt = 4, 30, 26
    preds = np.stack([_mels(rng, t_pred, unvoiced=range(0, 30, 3))
                      for _ in range(b)]).astype(dtype)
    targets = np.stack([_mels(rng, t_tgt) for _ in range(b)]).astype(dtype)
    preds[2] = -np.abs(preds[2]) - 0.1        # every frame unvoiced -> None
    targets[3, :5] = -1.0
    pred_lengths = [30, 17, 30, 9]
    target_lengths = [26, 26, 11, 5]          # row 3: only unvoiced frames
    got = port.calculate_mse_dtw(preds, pred_lengths, targets,
                                 target_lengths)
    want = ref.calculate_mse_dtw(preds, pred_lengths, targets,
                                 target_lengths)
    assert got[2] is None and got[3] is None
    assert [g is None for g in got] == [w is None for w in want]
    np.testing.assert_allclose([g for g in got if g is not None],
                               [w for w in want if w is not None],
                               rtol=1e-12, atol=0)


PAIRS = [("", ""), ("", "abc"), ("kitten", "sitting"), ("flaw", "lawn"),
         ("héllo wörld", "hello world"), ("你好世界", "你们好"),
         ("a" * 40, "ab" * 25)]


@pytest.mark.parametrize("a,b", PAIRS)
def test_levenshtein_matches_jax(a, b):
    assert port.levenshtein(a, b) == ref.levenshtein(a, b)
    assert port.levenshtein(b, a) == ref.levenshtein(a, b)


TEXTS = [("Hello, World!  It's  (a) test.", "en-us"),
         ("¿Qué tal? «Bien» — gracias…", "es-es"),
         ("你好， 世界！ 今天 天气 很好。", "zh-cn"),
         ("こんにちは 、 世界 「テスト」", "ja-jp"),
         ("안녕 하세요, 세계!", "ko-kr"),
         ("Ünïcödé  ÀÉÎ", "de-de")]


@pytest.mark.parametrize("text,locale", TEXTS)
def test_basic_normalize_matches_jax(text, locale):
    got = port.basic_normalize(text, locale)
    assert got == ref.basic_normalize(text, locale)
    if locale in ("zh-cn", "ja-jp", "ko-kr"):
        assert " " not in got


@pytest.mark.parametrize("truth,pred,locale", [
    ("Hello world.", "hello word", "en-us"),
    ("你好，世界！", "你 好 世 界", "zh-cn"),
    ("abc", "", "en-us"),
    ("the cat sat", "a dog stood up", "en-us")])
def test_character_error_rate_matches_jax(truth, pred, locale):
    got = port.character_error_rate(truth, pred, locale)
    want = ref.character_error_rate(truth, pred, locale)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert 0.0 <= got <= 1.0


class _Response(io.BytesIO):
    def __init__(self, status, body):
        super().__init__(body)
        self.status = status


@pytest.fixture
def azure(tmp_path, monkeypatch):
    """An azure_key.json in the working directory and a fake urlopen that
    records each request and answers with what ``reply`` holds."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "azure_key.json").write_text(json.dumps(
        {"region": "westus", "subscription": "KEY"}))
    (tmp_path / "a_trim.wav").write_bytes(b"RIFFwav")
    seen, reply = [], {}

    def urlopen(request):
        seen.append(request)
        if reply.get("raise"):
            raise urllib.error.HTTPError(request.full_url, 401, "denied",
                                         {}, None)
        return _Response(reply.get("status", 200), json.dumps(
            reply.get("body", {})).encode())

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return tmp_path, seen, reply


def test_transcribe_available_follows_the_key_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert port.transcribe_available() is ref.transcribe_available() is False
    (tmp_path / "azure_key.json").write_text("{}")
    assert port.transcribe_available() is ref.transcribe_available() is True


@pytest.mark.parametrize("status,raises,ok", [(200, False, True),
                                              (201, False, False),
                                              (401, True, False)])
def test_azure_transcribe_request_and_status(azure, status, raises, ok):
    root, seen, reply = azure
    body = {"RecognitionStatus": "Success",
            "NBest": [{"Lexical": "ni hao"}]}
    reply.update({"status": status, "body": body, "raise": raises})
    got = port.azure_transcribe(str(root / "a_trim.wav"), "zh")
    assert got == (body if ok else None)
    (request,) = seen
    assert request.full_url == (
        "https://westus.stt.speech.microsoft.com/speech/recognition/"
        "conversation/cognitiveservices/v1?format=detailed&profanity=raw"
        "&language=zh-cn")
    assert request.get_method() == "POST" and request.data == b"RIFFwav"
    assert request.get_header("Ocp-apim-subscription-key") == "KEY"
    assert request.get_header("Content-type") == "audio/wav"


@pytest.mark.parametrize("answer", ["success", "failure"])
def test_transcribe_matches_jax(answer, monkeypatch, tmp_path):
    """``transcribe`` around the same service answer (success, or a
    failure on all five tries) gives the JAX package's record."""
    wav = tmp_path / "en0_1_trim.wav"
    wav.write_bytes(b"RIFF")
    meta = {"n": "en0_1.npy", "t": "Hello, there world!", "i": "en_us"}
    result = {"RecognitionStatus": "Success", "DisplayText": "Hello there.",
              "NBest": [{"Lexical": "hello their world"}]}
    calls = []

    def fake(audio_path, lang):
        calls.append(lang)
        return dict(result) if answer == "success" else None

    monkeypatch.setattr(port, "azure_transcribe", fake)
    monkeypatch.setattr(ref, "azure_transcribe", fake)
    to_lang = lambda x: x.replace("_", "-")
    got = port.transcribe(str(wav), meta, to_lang)
    want = ref.transcribe(str(wav), meta, to_lang)
    assert got == want
    assert calls == ["en-us"] * (2 if answer == "success" else 10)
    assert got["name"] == "en0_1" and got["locale"] == "en-us"
    assert got.get("fail", False) == (answer == "failure")
