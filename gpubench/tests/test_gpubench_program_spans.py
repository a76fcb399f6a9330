"""The readers of the program's own spans and counters: each gives its
number on a hand-made list of windows and None where no unprofiled window
follows the profiled one; a tiny traced run of each cell on the CPU prints
them all."""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from gpubench import program_spans, spec
from gpubench.run import run_cell
from gpubench.tests.tiny import tiny_bench

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _value(name):
    s = importlib.util.spec_from_file_location(
        "program_span_metric_" + name.replace(".", "_"),
        METRICS / (name + ".py"))
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module.value


def _window(profiled, spans=None, counters=None):
    return {"index": 0, "profiled": profiled, "spans": spans or {},
            "counters": counters or {}}


# the unprofiled window after the traced stretch: 4 steps, 8 frame steps of
# 2 calls
AFTER = _window(False, spans={
    "train.step": (4, 2.0, 0.1),
    "train.forward": (4, 0.4, 0.3), "train.loss": (4, 0.04, 0.04),
    "train.backward": (4, 0.8, 0.6), "train.optimizer": (8, 0.2, 0.2),
    "data.device_batch": (5, 0.05, 0.01), "data.h2d": (5, 0.03, 0.03),
    "data.get_batch": (5, 0.002, 0.002),
    "synth.call": (2, 1.0, 0.01), "synth.frame": (8, 0.004, 0.002),
    "synth.stop_check": (1, 0.3, 0.3),
    "synth.prepare": (2, 0.002, 0.001), "synth.weights": (4, 0.02, 0.02),
    "synth.encode": (2, 0.05, 0.01), "synth.postnet": (2, 0.003, 0.002),
    "vocode.griffin_lim": (2, 0.01, 0.006)},
    counters={"data.frames": 900, "data.padded_frames": 100,
              "synth.frame_steps": 8})
# the same names, ten times larger, in the profiled window before it
TRACED = _window(True, spans={k: (n, 10 * s, 10 * o) for k, (n, s, o)
                              in AFTER["spans"].items()},
                 counters={"data.frames": 1, "data.padded_frames": 9,
                           "synth.frame_steps": 1})
EXPECTED = {
    "fwd_host_ms.train": 1e3 * 0.44 / 4,
    "bwd_host_ms.train": 1e3 * 0.8 / 4,
    "opt_host_ms.train": 1e3 * 0.2 / 4,
    "h2d_host_ms.train": 1e3 * 0.03 / 5,
    "get_batch_ms.train": 1e3 * 0.002 / 5,
    "feeder_pad_share.train": 10.0,
    "frame_host_us.synth": 1e6 * 0.004 / 8,
    "stop_wait_ms.synth": 1e3 * 0.3 / 2,
    "frame_host_us.utt": 1e6 * 0.004 / 8,
    "request_fixed_ms.utt": 1e3 * (0.001 + 0.02 + 0.01 + 0.002 + 0.006) / 2,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_hand_made_windows(name):
    value = _value(name)
    before = _window(False, spans=AFTER["spans"], counters={
        "data.frames": 1, "data.padded_frames": 1, "synth.frame_steps": 1})
    got = value([before, TRACED, AFTER])
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)
    # a later profiled stretch: the window after it is the one read
    assert value([before, TRACED, before, TRACED, AFTER]) == got


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_without_a_window_after_the_trace(name):
    value = _value(name)
    assert value([]) is None
    assert value([AFTER]) is None                   # never profiled
    assert value([AFTER, TRACED]) is None           # nothing after it
    assert value([TRACED, _window(False)]) is None  # nothing to divide by


def test_after_trace_takes_the_window_right_after_the_last_profiled():
    a, b = _window(False), _window(False)
    assert program_spans.after_trace([a, TRACED, b]) is b
    assert program_spans.after_trace([TRACED, a, TRACED, b]) is b
    assert program_spans.after_trace([TRACED, a, TRACED]) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("tiny_spans"))


@pytest.mark.parametrize("cell_name,names", [
    ("flagship.train", ["fwd_host_ms.train", "bwd_host_ms.train",
                        "opt_host_ms.train", "h2d_host_ms.train",
                        "get_batch_ms.train", "feeder_pad_share.train"]),
    ("flagship.synth", ["frame_host_us.synth", "stop_wait_ms.synth"]),
    ("ljspeech.utt", ["frame_host_us.utt", "request_fixed_ms.utt"])])
def test_a_traced_run_prints_the_program_span_metrics(tiny, cell_name,
                                                      names):
    from few_shot_transformer_tts_torch.utils import tracing
    tracing.reset()
    cell = spec.load_cell(tiny, cell_name, base=tiny)
    # the first unit traced, and one thread (tests run side by side), so
    # that units follow it within the window
    cell.mix.update({"trace_after_steps": 0, "traced_steps": 1,
                     "traced_calls": 1, "traced_requests": 1})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, _, _ = run_cell(cell, 2 ** 31 + 99, 8.0, True,
                                torch.device("cpu"), 0.0)
    finally:
        torch.set_num_threads(threads)
    seen = [(w["profiled"], {k: v[0] for k, v in w["spans"].items()
                             if k in ("train.step", "synth.call")})
            for w in program_spans.windows()]
    for name in names:
        assert name in result["metrics"], (name, seen)
        v = result["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, name
    assert program_spans.after_trace(program_spans.windows()) is not None
