"""Shared corpus-normalization toolkit.

The reference implements 15 near-identical preprocessor scripts
(reference corpora/*.py); the repeated pattern — copy/convert audio to
``{transformed}/{corpus}/wavs/{SPK}_{%010d}.wav``, write ``metadata.csv``
rows ``name|script|speaker|lang``, skip digit-bearing scripts, drop
too-small speakers — lives here once, and each dataset adapter in
datasets.py supplies only its quirks.

Audio IO is dependency-light: wav via scipy, raw PCM via numpy, duration
from the wav header, resampling via polyphase scipy, flac via ``soundfile``
where it is installed, else the ``ffmpeg`` binary.

Own copy of ``few_shot_transformer_tts_tpu/corpora/common.py``.
"""

from __future__ import annotations

import logging
import os
import shutil
import struct
from collections import defaultdict
from typing import Iterable, List, Optional, Tuple

import numpy as np


def wav_duration(path: str) -> float:
    """Duration in seconds from the wav header (no decode).  Handles PCM and
    float formats (stdlib wave rejects IEEE-float wavs)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError("not a wav file: %s" % path)
        sr = None
        block_align = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id, size = header[:4], struct.unpack("<I", header[4:])[0]
            if chunk_id == b"fmt ":
                fmt = f.read(size)
                _, channels, sr = struct.unpack("<HHI", fmt[:8])
                block_align = struct.unpack("<H", fmt[12:14])[0]
            elif chunk_id == b"data":
                if sr is None:
                    raise ValueError("data chunk before fmt: %s" % path)
                return size / block_align / float(sr)
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)
        raise ValueError("no data chunk: %s" % path)


def load_audio(path: str, sr: int = 16000) -> np.ndarray:
    """Load wav/flac mono float32 at the target rate."""
    from ..ops.dsp import load_wav
    if path.lower().endswith(".flac"):
        return _load_flac(path, sr)
    return load_wav(path, sr)


def _load_flac(path: str, sr: int) -> np.ndarray:
    """flac via soundfile when present, else the ffmpeg binary; raises
    RuntimeError when neither is there."""
    try:
        import soundfile as sf
    except ImportError:
        return _load_flac_ffmpeg(path, sr)
    y, file_sr = sf.read(path, dtype="float32")
    if y.ndim > 1:
        y = y.mean(axis=-1)
    if file_sr != sr:
        from ..ops.dsp import resample_poly
        y = resample_poly(y, sr, file_sr)
    return y.astype(np.float32)


def _load_flac_ffmpeg(path: str, sr: int) -> np.ndarray:
    import subprocess
    import tempfile
    from ..ops.dsp import load_wav
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            "reading %s needs the soundfile package or the ffmpeg binary on "
            "PATH; neither was found" % path)
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        subprocess.run([ffmpeg, "-y", "-loglevel", "error", "-i", path,
                        "-ar", str(sr), "-ac", "1", tmp.name], check=True)
        return load_wav(tmp.name, sr)


def load_raw_pcm16be(path: str, channels: int = 2, sr_in: int = 44100,
                     sr_out: int = 16000, skip_frames: int = 10) -> np.ndarray:
    """Raw big-endian PCM16 (the NST corpora) -> mono float32 at sr_out."""
    data = np.fromfile(path, dtype=">i2").astype(np.float32) / 32768.0
    if channels > 1:
        data = data[: len(data) // channels * channels]
        data = data.reshape(-1, channels)[:, 0]
    data = data[skip_frames:]
    if sr_in != sr_out:
        from ..ops.dsp import resample_poly
        data = resample_poly(data, sr_out, sr_in)
    return data


def save_wav16(y: np.ndarray, path: str, sr: int = 16000):
    from scipy.io import wavfile
    wavfile.write(path, sr, y)


def has_digit(script: str) -> bool:
    return any(c.isdigit() for c in script)


def has_ascii_digit(script: str) -> bool:
    return any(c in "1234567890" for c in script)


class CorpusWriter:
    """Accumulates normalized samples for one corpus directory."""

    def __init__(self, transformed_path: str, corpus_name: str):
        self.corpus = corpus_name
        self.out_path = os.path.join(transformed_path, corpus_name)
        self.wav_path = os.path.join(self.out_path, "wavs")
        os.makedirs(self.wav_path, exist_ok=True)
        self.rows: List[Tuple[str, str, str, str]] = []
        self.total_dur = 0.0
        self.n_skip = 0
        self._spk_counters = defaultdict(int)

    def add(self, wav_file: str, script: str, speaker: str, lang: str,
            dur: Optional[float] = None, audio: Optional[np.ndarray] = None,
            sr: int = 16000) -> str:
        """Register a sample: copies the wav (or writes the given audio) under
        the canonical name and appends the metadata row."""
        i = self._spk_counters[speaker]
        self._spk_counters[speaker] += 1
        name = "%s_%010d" % (speaker, i)
        dst = os.path.join(self.wav_path, name + ".wav")
        if audio is not None:
            save_wav16(audio, dst, sr)
            dur = len(audio) / sr if dur is None else dur
        else:
            shutil.copy(wav_file, dst)
            if dur is None:
                dur = wav_duration(wav_file)
        self.total_dur += dur
        self.rows.append((name, script, speaker, lang))
        return name

    def skip(self, n: int = 1):
        self.n_skip += n

    def drop_small_speakers(self, min_samples: int) -> int:
        """Remove all samples of speakers below the minimum (adapters that
        filter before copying do it themselves; this is the post-hoc form)."""
        counts = defaultdict(int)
        for name, _, spk, _ in self.rows:
            counts[spk] += 1
        dropped = [r for r in self.rows if counts[r[2]] < min_samples]
        self.rows = [r for r in self.rows if counts[r[2]] >= min_samples]
        for name, _, _, _ in dropped:
            path = os.path.join(self.wav_path, name + ".wav")
            if os.path.exists(path):
                os.remove(path)
        self.n_skip += len(dropped)
        return len(set(r[2] for r in dropped))

    def finish(self):
        with open(os.path.join(self.out_path, "metadata.csv"), "w",
                  encoding="utf-8") as fw:
            for row in self.rows:
                fw.write("|".join(row) + "\n")
        logging.info("%s: %d samples, %d skipped, %.2f h", self.corpus,
                     len(self.rows), self.n_skip, self.total_dur / 3600)
        print("%s: %d samples, %d skipped" % (self.corpus, len(self.rows),
                                              self.n_skip))
        print("Total duration: %.2f h, %.2f min" % (
            self.total_dur / 3600, self.total_dur / 60))


def group_speaker_samples(samples: Iterable[Tuple[str, str, float, str]],
                          min_samples: int):
    """(wav_file, script, dur, speaker) stream -> {speaker: sorted list},
    dropping speakers below the minimum (the multi-speaker pattern of the
    reference's google/caito/jsut adapters)."""
    spk_samples = defaultdict(list)
    for wav_file, script, dur, spk in samples:
        spk_samples[spk].append((wav_file, script, dur))
    n_skip = 0
    n_spk_skip = 0
    for spk in list(spk_samples.keys()):
        if len(spk_samples[spk]) < min_samples:
            n_skip += len(spk_samples[spk])
            del spk_samples[spk]
            n_spk_skip += 1
        else:
            spk_samples[spk].sort()
    return spk_samples, n_skip, n_spk_skip
