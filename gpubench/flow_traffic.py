"""Traffic of the ``flow_synth`` kind: batches of zero-shot voice-cloning
rows for F5-TTS, from the run's seed, by ``traffic.strata`` and
``traffic.text``.

A batch of ``batch`` rows: prompt frames stratified over
``prompt_frames`` (one per ``batch``-th of the range, shuffled); a prompt
text of ``prompt_bytes_per_s`` bytes a second of prompt x (1 +-
``prompt_bytes_jitter``), at ``sr`` / ``hop_length`` frames a second;
target texts stratified over ``target_bytes`` and paired with the prompts
by the seed's shuffles; prompt mels uniform in ``mel_range`` (F5's log-mel
range); x_0 unit normals over each row's frames, zero past them.  A row's
frames follow the reference's duration rule (``reference/f5tts.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import traffic
from .reference import f5tts as ref
from .weights import generator


def flow_batches(mix, hp, seed: int, count: int, device) -> list:
    """[batch dict] for ``synthesize_batch`` under ``hp.model == "f5tts"``,
    each with its ``noise`` on ``device`` and the reference's
    ``durations``."""
    rng = np.random.default_rng([seed, 20])
    b = mix["batch"]
    fps = hp.sr / hp.hop_length
    lo_v, hi_v = mix["mel_range"]
    out = []
    for k in range(count):
        frames = traffic.strata(*mix["prompt_frames"], b, rng)
        target = traffic.strata(*mix["target_bytes"], b, rng)
        jitter = mix["prompt_bytes_jitter"] * (
            2 * traffic.strata(0, 10 ** 6, b, rng) / 10 ** 6 - 1)
        pbytes = np.maximum(1, np.round(frames / fps * mix[
            "prompt_bytes_per_s"] * (1 + jitter))).astype(np.int64)
        texts = [traffic.text(int(p), rng) + traffic.text(int(t), rng)
                 for p, t in zip(pbytes, target)]
        lengths = np.asarray([len(t) for t in texts], np.int64)
        inputs = np.full((b, int(lengths.max())), -1, np.int64)
        for i, t in enumerate(texts):
            inputs[i, :len(t)] = np.frombuffer(t, np.uint8)
        durs = [ref.duration(int(frames[i]), int(pbytes[i]), int(target[i]),
                             int(lengths[i]), mix["max_frames"])
                for i in range(b)]
        gen = generator(seed, 1000 + k, device)
        mels = (torch.rand(int(frames.sum()), hp.num_mels, generator=gen,
                           device=device) * (hi_v - lo_v) + lo_v).cpu()
        starts = np.concatenate([[0], np.cumsum(frames)])
        noise = torch.zeros((b, max(durs), hp.num_mels), device=device)
        for i, n in enumerate(durs):
            noise[i, :n] = torch.randn((n, hp.num_mels), generator=gen,
                                       device=device)
        out.append({
            "inputs": inputs, "input_lengths": lengths,
            "prompt_bytes": pbytes,
            "prompt_mels": [mels[starts[i]:starts[i + 1]].numpy()
                            for i in range(b)],
            "noise": noise, "durations_expected": durs,
            "names": ["b%d_r%d" % (k, i) for i in range(b)]})
    return out
