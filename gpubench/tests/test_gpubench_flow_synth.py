"""The ``flow_synth`` kind on the CPU at a tiny size: a sound run is
correct and prints its metrics; a fault planted in each number the check
compares turns ``correct`` false; the control fails the limits; the
reader, counts and traffic of the kind."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import few_shot_transformer_tts_torch.infer.flow as flow_mod
from few_shot_transformer_tts_torch.config import Config
from gpubench import f5counts, flow_traffic, program_spans, spec
from gpubench.run import run_cell
from gpubench.tests.tiny import tiny_bench

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4321
METRICS = Path(__file__).resolve().parents[1] / "metrics"
TINY_F5 = dict(model="f5tts", dit_dim=64, dit_depth=2, dit_heads=4,
               text_dim=32, text_conv_layers=1, num_mels=20,
               use_bfloat16=False, use_pallas_attention=False, flow_nfe=4,
               sr=2400, hop_length=32)
FLOW_MIX = {"kind": "flow_synth", "batch": 3, "prompt_frames": [10, 30],
            "prompt_bytes_per_s": 15.0, "prompt_bytes_jitter": 0.2,
            "target_bytes": [6, 20], "mel_range": [-11.5, 2.0],
            "max_frames": 4096, "batches": 3, "traced_calls": 1,
            "sample_rows": 2, "velocity_steps": [0, 2, 3]}


# the tiny flow cell runs in float32, where the program reads ~1e-7 of the
# reference (the card's limits are set for bf16 at full size); the
# control's float8 reads 0.03-0.1
TINY_FLOW_LIMITS = {"limits": {"mel_gap": 1e-3, "velocity_gap": 1e-3,
                               "prompt_faults": 0, "length_faults": 0}}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    base = tiny_bench(tmp_path_factory.mktemp("tiny_flow"),
                      limits={"f5tts_base.flow_synth": TINY_FLOW_LIMITS})
    (base / "configs" / "f5tts_base.json").write_text(json.dumps(
        {"name": "f5tts_base", "hparams": Config(**TINY_F5).values()}))
    (base / "traffic" / "flow_synth.json").write_text(json.dumps(FLOW_MIX))
    return base


def _run(tiny, name, trace=False, variants=(), seconds=0.3):
    cell = spec.load_cell(tiny, name, base=tiny)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run_cell(cell, SEED, seconds, trace, CPU, 0.0, variants)
    finally:
        torch.set_num_threads(threads)


def _failed(result):
    return [n for n, c in result["checks"].items()
            if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct_and_reports(tiny, trace):
    name = "f5tts_base.flow_synth"
    # a traced run needs untraced units after the traced one for the
    # host-clock metrics, also on a loaded machine
    result, lines, _ = _run(tiny, name, bool(trace),
                            seconds=3.0 if trace else 0.3)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["attempted"] >= 1
    cell = spec.load_cell(tiny, name, base=tiny)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    if trace:
        # the CPU has no device trace: only the host-clock metrics
        want = {n for n in names if n.startswith(("mfu.", "ode_step"))}
    else:
        want = names
    assert set(result["metrics"]) >= want
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    tail = lines[-len(result["checks"]):]
    assert [ln.split()[0] for ln in tail] == list(result["checks"])


def _velocity_noise(monkeypatch):
    real = flow_mod._Call.velocity

    def noisy(self, model, x, i):
        v = real(self, model, x, i)
        if i == 1:
            g = torch.Generator().manual_seed(0)
            v = v + v.pow(2).mean().sqrt() * torch.randn(
                v.shape, generator=g)
        return v
    monkeypatch.setattr(flow_mod._Call, "velocity", noisy)


def _cfg_half_dropped(monkeypatch):
    def conditional_only(self, model, x, i):
        v2 = model.velocity_packed(torch.cat([x, x]), self.cond2,
                                   self.text2, self.packing,
                                   [m[i] for m in self.mods])
        return v2[:x.shape[0]]
    monkeypatch.setattr(flow_mod._Call, "velocity", conditional_only)


def _sway_sign(monkeypatch):
    real = flow_mod.flow_times
    monkeypatch.setattr(flow_mod, "flow_times",
                        lambda nfe, sway, device=None: real(nfe, -sway,
                                                            device))


def _prompt_unrestored(monkeypatch):
    real = flow_mod._Call.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        self.prompt = torch.zeros_like(self.prompt)
    monkeypatch.setattr(flow_mod._Call, "__init__", init)


def _duration_off(monkeypatch):
    real = flow_mod.f5_duration
    monkeypatch.setattr(flow_mod, "f5_duration",
                        lambda *a: real(*a) + 1)


@pytest.mark.parametrize("plant,numbers", [
    (_velocity_noise, {"mel_gap"}),
    (_cfg_half_dropped, {"mel_gap", "velocity_gap"}),
    (_sway_sign, {"velocity_gap"}),
    (_prompt_unrestored, {"prompt_faults"}),
    (_duration_off, {"length_faults"})])
def test_a_flow_fault_is_seen(tiny, monkeypatch, plant, numbers):
    plant(monkeypatch)
    result, _, _ = _run(tiny, "f5tts_base.flow_synth")
    assert not result["correct"]
    assert numbers <= set(_failed(result)), result["checks"]


def test_the_control_fails_the_limits(tiny):
    name = "f5tts_base.flow_synth"
    cell = spec.load_cell(tiny, name, base=tiny)
    limits = cell.limits["limits"]
    _, _, extra = _run(tiny, name, variants=("fp8",))
    assert any(v > limits[n] for n, v in extra["fp8"].items()
               if n in limits), extra


def _window(profiled, spans=None, counters=None):
    return {"index": 0, "profiled": profiled, "spans": spans or {},
            "counters": counters or {}}


def _value(name):
    import importlib.util
    s = importlib.util.spec_from_file_location(
        "flow_metric_" + name.replace(".", "_"), METRICS / (name + ".py"))
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module.value


def test_ode_step_host_ms_reads_the_window_after_the_trace():
    value = _value("ode_step_host_ms.flow_synth")
    after = _window(False, spans={"synth.ode_step": (64, 3.2, 0.1)},
                    counters={"synth.ode_steps": 64})
    traced = _window(True, spans={"synth.ode_step": (32, 9.0, 0.2)},
                     counters={"synth.ode_steps": 32})
    assert value([after, traced, after]) == pytest.approx(50.0)
    assert value([]) is None and value([after]) is None
    assert value([traced, _window(False)]) is None
    assert program_spans.after_trace([traced, after]) is after


def test_f5_counts_against_hand_worked_shapes():
    hp = Config(model="f5tts", num_mels=100)
    n = 1250
    d = 1024
    block = 2 * n * 4 * d * d + 2 * 2 * n * d * 2 * d + 4 * n * n * d
    inp = 2 * n * 712 * d + 2 * 2 * n * d * 64 * 31
    assert f5counts.dit_pass_flops(hp, n) == pytest.approx(
        inp + 22 * block + 2 * n * d * 100)
    # ~0.50 GFLOP a frame a pass at the mean row
    assert 0.45e9 < f5counts.dit_pass_flops(hp, n) / n < 0.55e9
    assert f5counts.text_flops(hp, n) == pytest.approx(
        4 * (2 * n * 512 * 7 + 2 * 2 * n * 512 * 1024))
    assert f5counts.sample_row_flops(hp, n) == pytest.approx(
        64 * f5counts.dit_pass_flops(hp, n) + 2 * f5counts.text_flops(hp, n))


def test_flow_traffic_repeats_per_seed_and_stratifies():
    hp = Config(**TINY_F5)
    mix = {**FLOW_MIX, "batch": 4, "prompt_frames": [282, 938],
           "target_bytes": [24, 180]}
    a = flow_traffic.flow_batches(mix, hp, SEED, 2, CPU)
    b = flow_traffic.flow_batches(mix, hp, SEED, 2, CPU)
    c = flow_traffic.flow_batches(mix, hp, SEED + 1, 2, CPU)
    for x, y in zip(a, b):
        assert np.array_equal(x["inputs"], y["inputs"])
        assert torch.equal(x["noise"], y["noise"])
    assert not np.array_equal(a[0]["inputs"], c[0]["inputs"])
    for batch in a:
        frames = sorted(len(p) for p in batch["prompt_mels"])
        edges = 282 + (938 - 282 + 1) * np.arange(5) / 4
        assert all(edges[i] <= f < edges[i + 1]
                   for i, f in enumerate(frames))
        target = batch["input_lengths"] - batch["prompt_bytes"]
        assert target.min() >= 24 and target.max() <= 180
        rate = batch["prompt_bytes"] / (np.asarray(
            [len(p) for p in batch["prompt_mels"]]) / (2400 / 32))
        assert np.all(np.abs(rate / 15.0 - 1) <= 0.2 + 0.05)
        for i, n in enumerate(batch["durations_expected"]):
            assert not batch["noise"][i, n:].any()
            assert batch["noise"][i, :n].abs().sum() > 0


@pytest.mark.card
def test_the_control_fails_at_the_cells_size(card):
    """The program passes and the control fails on one seed at the cell's
    own size (``python -m gpubench.calibrate``)."""
    import subprocess
    import sys
    name = "f5tts_base.flow_synth"
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.calibrate", "--workload", name,
         "--seeds", "2147483999", "--control-seeds", "2147483999"],
        capture_output=True, text=True, cwd=str(root), timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = spec.load_cell(root, name).limits["limits"]
    assert line["correct"]
    assert any(v > limits[n] for n, v in line["control"]["fp8"].items()
               if n in limits)
