"""The correctness check sees faults: a run driven on the CPU at tiny size
with the timed path broken underneath must come out not correct, once for
each fault the cell can have; and the control (the reference one precision
step below the configuration's) must fail the cell's limits.  The control
at the cells' own size runs on a card (marked ``card``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import few_shot_transformer_tts_torch.infer.synthesize as synth_mod
import few_shot_transformer_tts_torch.ops.decode as decode_mod
import few_shot_transformer_tts_torch.train.loop as loop_mod
from gpubench import spec
from gpubench.run import run_cell
from gpubench.tests.tiny import tiny_bench

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("tiny"))


def _run(tiny, name, seed=91):
    cell = spec.load_cell(tiny, name, base=tiny)
    result, _, _ = run_cell(cell, seed, 0.3, False, CPU, 0.0)
    return result


def _failed(result):
    return [n for n, c in result["checks"].items()
            if not c["value"] <= c["limit"]]


def test_sound_runs_are_correct(tiny):
    for name in ("flagship.train", "flagship.synth", "ljspeech.utt"):
        assert _run(tiny, name)["correct"], name


def test_a_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    real = loop_mod.train_step

    def frozen(model, optimizer, *a, **k):
        saved = [p.detach().clone() for p in model.parameters()]
        out = real(model, optimizer, *a, **k)
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)
        return out
    monkeypatch.setattr(loop_mod, "train_step", frozen)
    result = _run(tiny, "flagship.train")
    assert not result["correct"] and "update_gap" in _failed(result)


def test_a_window_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    """Only steps after set-up's are broken: the check of the window's
    step catches what the first steps' cannot."""
    real = loop_mod.train_step
    compared = json.loads((tiny / "traffic" / "train.json").read_text())[
        "compared_steps"]
    done = []

    def frozen_later(model, optimizer, *a, **k):
        saved = [p.detach().clone() for p in model.parameters()]
        out = real(model, optimizer, *a, **k)
        done.append(1)
        if len(done) > compared:
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
        return out
    monkeypatch.setattr(loop_mod, "train_step", frozen_later)
    result = _run(tiny, "flagship.train")
    assert not result["correct"]
    assert "window_update_gap" in _failed(result)
    assert "update_gap" not in _failed(result)


def test_half_the_batch_left_out_of_the_mean(tiny, monkeypatch):
    real = loop_mod.compute_loss

    def half(model, mel_targets, target_lengths, *a, **k):
        kept = target_lengths.clone()
        kept[1::2] = 0
        return real(model, mel_targets, kept, *a, **k)
    monkeypatch.setattr(loop_mod, "compute_loss", half)
    result = _run(tiny, "flagship.train")
    assert not result["correct"]
    assert {"grad_gap", "loss_gap"} & set(_failed(result))


@pytest.mark.parametrize("name", ["flagship.synth", "ljspeech.utt"])
def test_a_frame_altered_where_it_is_produced(tiny, monkeypatch, name):
    real = decode_mod.decoder_frame_step

    def altered(x, step, *a, **k):
        out = real(x, step, *a, **k)
        if step == 3:
            x = out[0].clone()
            x[:, :7] += 1.0     # a shift of all channels would pass the LN
            out = (x,) + tuple(out[1:])
        return out
    monkeypatch.setattr(decode_mod, "decoder_frame_step", altered)
    result = _run(tiny, name)
    assert not result["correct"] and "frame_gap" in _failed(result)


@pytest.mark.parametrize("name", ["flagship.synth", "ljspeech.utt"])
def test_a_decode_step_that_leaves_its_cache_unchanged(tiny, monkeypatch,
                                                       name):
    real = decode_mod.decoder_frame_step

    def stale(*a, **k):
        x, align, k_new, v_new = real(*a, **k)
        return x, align, torch.zeros_like(k_new), torch.zeros_like(v_new)
    monkeypatch.setattr(decode_mod, "decoder_frame_step", stale)
    result = _run(tiny, name)
    assert not result["correct"] and "frame_gap" in _failed(result)


def test_a_waveform_altered_where_it_is_produced(tiny, monkeypatch):
    real = synth_mod.vocode_batch

    def altered(*a, **k):
        out = [w.copy() for w in real(*a, **k)]
        for w in out:
            w[3 * len(w) // 4:] = 0.0     # the last quarter lost
        return out
    monkeypatch.setattr(synth_mod, "vocode_batch", altered)
    result = _run(tiny, "ljspeech.utt")
    assert not result["correct"] and _failed(result) == ["wave_sc_gap"]


def test_a_waveform_cut_short(tiny, monkeypatch):
    real = synth_mod.vocode_batch

    def short(*a, **k):
        return [w[:-7] for w in real(*a, **k)]
    monkeypatch.setattr(synth_mod, "vocode_batch", short)
    result = _run(tiny, "ljspeech.utt")
    assert not result["correct"] and "wave_len_faults" in _failed(result)


@pytest.mark.parametrize("name", ["flagship.train", "flagship.synth",
                                  "ljspeech.utt"])
def test_the_control_fails_the_limits(tiny, name):
    cell = spec.load_cell(tiny, name, base=tiny)
    limits = cell.limits["limits"]
    _, _, extra = run_cell(cell, 93, 0.3, False, CPU, 0.0,
                           variants=("fp8",))
    assert any(v > limits[n] for n, v in extra["fp8"].items()
               if n in limits), extra


@pytest.mark.card
@pytest.mark.parametrize("name", ["flagship.train", "flagship.synth",
                                  "ljspeech.utt"])
def test_the_control_fails_at_the_cells_size(card, name):
    """The program passes and the control fails on one seed at the cell's
    own size (``python -m gpubench.calibrate``)."""
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.calibrate", "--workload", name,
         "--seeds", "2147483999", "--control-seeds", "2147483999"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = spec.load_cell(ROOT, name).limits["limits"]
    assert line["correct"]
    assert any(v > limits[n] for n, v in line["control"]["fp8"].items()
               if n in limits)
