"""The port's data-parallel scaling benchmark
(``few_shot_transformer_tts_torch.parallel.scaling``) on the CPU: strong
mode at degrees 1 and 2 (gloo, small_test_config), 2 steps, one spawned
process per rank.  Each line carries the JAX module's fields; the global
batch stays fixed; degree 1 is the efficiency's reference."""

import json

import numpy as np

from few_shot_transformer_tts_torch.parallel import scaling

FIELDS = {"devices", "mode", "batch", "sec_per_step", "audio_s_per_sec",
          "audio_s_per_sec_per_device", "efficiency"}


def test_strong_mode_degrees_one_and_two(capsys):
    results = scaling.main(["--devices", "1,2", "--mode", "strong",
                            "--steps", "2", "--small", "--device", "cpu",
                            "--per_device_batch", "2", "--t_in", "16",
                            "--t_out", "24"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines == results
    assert [r["devices"] for r in results] == [1, 2]
    for r in results:
        assert FIELDS <= set(r)
        assert r["mode"] == "strong" and r["batch"] == 4
        assert r["backend"] == "gloo" and not r["shared_cards"]
        assert r["sec_per_step"] > 0 and np.isfinite(r["efficiency"])
        np.testing.assert_allclose(
            r["audio_s_per_sec_per_device"] * r["devices"],
            r["audio_s_per_sec"], rtol=1e-12)
    assert results[0]["efficiency"] == 1.0
    # the same global batch, so the same audio per step
    np.testing.assert_allclose(
        results[0]["audio_s_per_sec"] * results[0]["sec_per_step"],
        results[1]["audio_s_per_sec"] * results[1]["sec_per_step"])
