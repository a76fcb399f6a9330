"""The harness on the CPU at tiny sizes: discovery by name, the counts, the
generators, the result line's schema, and no JAX in a run."""

import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import counts, spec, traffic
from gpubench.run import FORBIDDEN, main, run_cell
from gpubench.tests.tiny import tiny_bench

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345          # past 32 signed bits, as a run's may be


def test_every_cell_and_metric_of_the_benchmark_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert cell.mix["kind"] in ("train", "batch_synth", "utterance")
        assert cell.limits["limits"], w["name"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer and set(cell.readers) == {
            m["name"] for m in cell.per_layer}
    with pytest.raises(KeyError):
        spec.load_cell(ROOT, "flagship.nothing")


def test_a_cell_and_a_metric_added_as_files_and_entries(tmp_path):
    base = tiny_bench(tmp_path)
    bench = json.loads((base / "BENCHMARK.json").read_text())
    mix = json.loads((base / "traffic" / "synth.json").read_text())
    mix["batch"] = 2
    (base / "traffic" / "dummy.json").write_text(json.dumps(mix))
    (base / "limits" / "flagship.dummy.json").write_text(
        (base / "limits" / "flagship.synth.json").read_text())
    (base / "metrics" / "dummy_calls.dummy.py").write_text(
        "def read(r):\n    return 10.0 * r.units\n")
    bench["workloads"].append({"name": "flagship.dummy", "config":
                               "flagship", "traffic": "dummy", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][1]["workloads"].append("flagship.dummy")
    bench["per_layer"].append({
        "name": "dummy_calls.dummy", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "frame loop",
        "moves": "synth_audio_s_per_s", "workloads": ["flagship.dummy"]})
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(base, "flagship.dummy", base=base)
    assert cell.mix["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["dummy_calls.dummy"]
    result, _, _ = run_cell(cell, SEED, 0.2, True, CPU, 0.0)
    assert result["metrics"]["dummy_calls.dummy"]["value"] == \
        10.0 * result["attempted"]


def _tiny_hp(**kw):
    base = dict(encoder_hidden=2, decoder_hidden=2, embed_size=2,
                n_encoder_layer=1, n_decoder_layer=1, multi_speaker=False,
                multi_lingual=False, prenet_hidden=1, num_mels=1,
                postnet_hidden=1, n_postnet_layer=2)
    base.update(kw)
    return SimpleNamespace(**base)


def test_counts_against_hand_worked_shapes():
    # q, k, v read and o written once (bf16), lse written (fp32)
    assert counts.attention_forward_s(1, 2, 2, 4, 1, False, False, 2) == \
        72 / counts.HBM_BYTES_PER_S
    # 64 queries x 64 keys at c=128: 4 * 4096 * 128 operations vs bytes
    b = counts.attention_forward_s(1, 64, 64, 128, 1, False, False, 2)
    assert b == max((2 * 64 * 128 + 2 * 64 * 128) * 2 + 64 * 4,
                    0) / counts.HBM_BYTES_PER_S
    causal = counts.attention_backward_s(2, 4, 4, 8, 2, True, True, 4)
    assert causal == max(((4 * 8 * 8) * 2 * 4 + 2 * 4 * 2 * 4 + 2 * 4 * 4)
                         / counts.HBM_BYTES_PER_S,
                         10.0 * 2 * 10 * 8 / counts.PEAK_FLOPS[4])
    assert counts.layernorm_backward_s(10, 4, 2) == \
        (3 * 10 * 4 * 2 + 3 * 4 * 4) / counts.HBM_BYTES_PER_S
    hp = _tiny_hp()
    # encoder 24*1*4 + 4*1*1*2 = 104; decoder 112 + 8 + 16 + 8 = 144;
    # prenet and heads 16; postnet 2 * (2*1*5) = 20: (284) x 3
    assert counts.train_row_flops(hp, 1, 1) == 852.0
    # 104 + memory 16 + 2 frames x 136 + self-attention 24 + postnet 40
    assert counts.decode_row_flops(hp, 1, 2) == 456.0
    step = counts.decode_step_s(100, 10, 1, 1, 3, 4, 2, 5, 2)
    assert step == (100 * 2 + 10 * 4 + 2 * 3 * 4 * 2 + 3 * 4 + 2 * 5 * 4 * 2
                    + 2 * 4 * 4 + 3 * 2 * 4 + 2 * 4 * 2) / \
        counts.HBM_BYTES_PER_S


def test_generators_repeat_per_seed_and_stratify(tmp_path):
    hp = SimpleNamespace(multi_lingual=True, multi_speaker=True,
                         max_num_language=5, max_num_speaker=7, num_mels=4)
    mix = {"batch": 8, "input_bytes": [24, 180]}
    a = traffic.synth_batches(mix, hp, SEED, 3)
    b = traffic.synth_batches(mix, hp, SEED, 3)
    c = traffic.synth_batches(mix, hp, SEED + 1, 3)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
    assert not np.array_equal(a[0]["inputs"], c[0]["inputs"])
    for batch in a + c:     # one length from each eighth of [24, 180]
        n = np.sort(batch["input_lengths"] - 2)
        edges = 24 + 157 * np.arange(9) / 8
        assert np.all((n >= np.floor(edges[:-1])) & (n < edges[1:]))
    umix = {"input_bytes": [24, 180], "frames_per_byte": 5,
            "frame_round": 8, "stratum_block": 16}
    reqs = traffic.utterances(umix, hp, SEED, 40)
    again = traffic.utterances(umix, hp, SEED, 40)
    assert [r[1] for r in reqs] == [r[1] for r in again]
    assert all(r[1] % 8 == 0 and r[1] >= 5 * (len(r[0]["inputs"][0]) - 2)
               for r in reqs)
    assert traffic.frame_cap(24, umix) == 120
    cmix = {"utterances": 20, "target_frames": [10, 29],
            "bytes_per_frame": 0.2, "bytes_jitter": 0.2,
            "mel_range": [-4.0, 4.0]}
    roots = [traffic.write_corpus(cmix, hp, s, str(tmp_path / str(i)), CPU)
             for i, s in enumerate((SEED, SEED))]
    files = [sorted(p.name for p in Path(r).iterdir()) for r in roots]
    assert files[0] == ["lang_id.json", "mels.zip", "metadata.train.txt",
                        "spk_id.json"]
    for name in files[0]:
        assert (Path(roots[0]) / name).read_bytes() == \
            (Path(roots[1]) / name).read_bytes()
    rows = (Path(roots[0]) / "metadata.train.txt").read_text().split()
    frames = sorted(int(r.split("|")[1]) for r in
                    (Path(roots[0]) / "metadata.train.txt").read_text()
                    .splitlines())
    assert frames == list(range(10, 30)) and rows


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name,trace", [
    ("flagship.train", 0), ("flagship.train", 1), ("flagship.synth", 0),
    ("flagship.synth", 1), ("ljspeech.utt", 0), ("ljspeech.utt", 1)])
def test_result_line_schema(tiny, name, trace):
    cell = spec.load_cell(tiny, name, base=tiny)
    result, lines, _ = run_cell(cell, SEED, 0.3, bool(trace), CPU, 0.0)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert ("breakdown" in keys) == bool(trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    want = cell.end_to_end if not trace else []
    assert set(result["metrics"]) >= {m["name"] for m in want}
    allowed = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    for k, m in result["metrics"].items():
        assert m["unit"] == allowed[k] and math.isfinite(m["value"])
    dev = result["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for n, c in result["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] is not None
    tail = lines[-len(result["checks"]):]
    assert [ln.split()[0] for ln in tail] == list(result["checks"])
    json.dumps(result)


def test_main_refuses_without_a_card_or_with_an_unknown_cell(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert main(["--workload", "flagship.synth", "--seed", "1",
                 "--seconds", "1", "--trace", "0"]) == 3
    assert main(["--workload", "nope", "--seed", "1", "--seconds", "1",
                 "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_a_cpu_run_of_each_mix_loads_no_jax(tiny):
    script = textwrap.dedent("""
        import sys, torch
        sys.path.insert(0, %r)
        from pathlib import Path
        from gpubench import spec
        from gpubench.run import run_cell, loaded_forbidden
        base = Path(%r)
        for name in ("flagship.train", "flagship.synth", "ljspeech.utt"):
            cell = spec.load_cell(base, name, base=base)
            run_cell(cell, 7, 0.2, True, torch.device("cpu"), 0.0)
        print("forbidden=" + ",".join(loaded_forbidden()))
        print("loaded=" + ",".join(sorted({m.split(".")[0]
                                           for m in sys.modules})))
    """) % (str(ROOT), str(tiny))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, loaded = (ln.split("=", 1)[1] for ln in
                         out.stdout.strip().splitlines()[-2:])
    assert forbidden == ""
    assert not set(loaded.split(",")) & set(FORBIDDEN)
    assert "few_shot_transformer_tts_torch" in loaded.split(",")
