"""Dataset packer: normalized corpora -> packed training set
(reference corpora/process_corpus.py:26-356); own copy of
``few_shot_transformer_tts_tpu/corpora/process_corpus.py``, whose packed
output it gives bit for bit on the numpy path.

Stages (same contracts, dependency-free DSP):
  trim_audios     edge noise-spike removal, long-internal-silence reject,
                  95th-percentile amplitude normalization to 0.244, exact
                  1600/2400-sample silence padding, 1-20 s gate
  recollect_meta  dedup (speaker, text), drop missing wavs, drop speakers
                  below the per-corpus sample minimum
  build_mels      wav -> normalized mel .npy: on ``--device`` cuda (the
                  default; raises without a card) batches of utterances
                  through the ``fused_frame_mel`` kernel (``ops/mel.py``,
                  ``csrc/frame_mel.cu``); on cpu numpy ``get_spectrograms``
                  per utterance in a process pool, as the reference does
  merge_datasets  all mels into one ZIP_STORED mels.zip, lang_id.json /
                  spk_id.json assigned in include_corpus order, 100 eval
                  samples per language, metadata.{train,eval}.txt rows
                  ``name.npy|n_frames|text|lang``
  statistics      per-language/speaker duration table -> lang_stat.tsv

Run as a module:  python -m few_shot_transformer_tts_torch.corpora.process_corpus
(each stage prints its wall time as ``<stage> stage: <seconds> s``)
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import multiprocessing
import os
import random
import shutil
import time
import zipfile
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from ..config import Config, default_config
from ..ops import dsp, dsp_torch
from ..utils.device import resolve_device
from . import (include_corpus, get_dataset_language,
               transformed_path as default_transformed,
               packed_path as default_packed)
from .common import wav_duration

# frames of one batch of the kernel's mels stage
MEL_BATCH_FRAMES = 16384


def min_speaker_samples(corpus_name: str) -> int:
    return 50 if corpus_name.startswith("google") else 100


def _corpus_dirs(transformed, corpus_list):
    if corpus_list is None:
        return sorted(glob.glob(os.path.join(transformed, "*")))
    return [os.path.join(transformed, c) for c in corpus_list]


# ---------------------------------------------------------------------------
# stage 1: trim (reference process_corpus.py:26-124)
# ---------------------------------------------------------------------------


def _peel_edge_spikes(spans, y_abs, peak):
    """Drop leading/trailing voiced spans that look like stray noise rather
    than speech, from each end inward until a real span is hit.

    A span is peeled when it is isolated from its inward neighbor by >= 4096
    samples AND is either faint (< peak/10) or both brief (no longer than
    half its gap to the neighbor) and quiet (< peak/4).  Empty spans peel
    unconditionally.  Constants are pinned by output parity with the
    reference recipe (reference corpora/process_corpus.py:51-75).

    Returns (surviving spans, number peeled).
    """
    lo, hi = 0, len(spans) - 1
    peeled = 0
    for step in (1, -1):            # from the head, then from the tail
        while hi > lo:
            edge = lo if step == 1 else hi
            start, stop = spans[edge]
            if start == stop:
                lo, hi = lo + (step == 1), hi - (step == -1)
                peeled += 1
                continue
            nb_start, nb_stop = spans[edge + step]
            gap = (nb_start - stop) if step == 1 else (start - nb_stop)
            span_peak = np.max(y_abs[start:stop])
            faint = span_peak < peak / 10
            brief_and_quiet = (stop - start) <= gap // 2 and \
                span_peak < peak / 4
            if gap >= 4096 and (faint or brief_and_quiet):
                lo, hi = lo + (step == 1), hi - (step == -1)
                peeled += 1
            else:
                break
    return spans[lo:hi + 1], peeled


def trim_wav(y: np.ndarray, corpus_name: str, sr: int = 16000):
    """One utterance through the trimming recipe (output parity with
    reference corpora/process_corpus.py:26-124).  Returns the processed wav,
    or (None, reason) when rejected."""
    spans = dsp.split_intervals(y, top_db=40, frame_length=2048,
                                hop_length=512)
    y_abs = np.abs(y)
    peak = np.max(y_abs)
    if len(spans) == 0:
        return None, "silent"

    spans, _ = _peel_edge_spikes([list(s) for s in spans], y_abs, peak)

    # long internal silence -> reject the sample; a few corpora with slower
    # read pacing get a looser gap budget (1 s vs 0.768 s)
    gap_budget = 16000 if (corpus_name in ["pt_br"] or
                           corpus_name.startswith("caito") or
                           corpus_name.startswith("css10")) else 12288
    for (_, stop), (nxt_start, _) in zip(spans, spans[1:]):
        if nxt_start - stop >= gap_budget:
            return None, "gap"

    # amplitude normalization: 95th percentile of voiced |amplitude| -> 0.244
    voiced = np.sort(np.abs(np.concatenate([y[l:r] for l, r in spans])))
    p95 = voiced[int(len(voiced) * 0.95)]
    if p95 <= 0:
        return None, "silent"
    y = y * (0.244 / p95)
    y = y[spans[0][0]: spans[-1][1]]

    # exact silence margins: 1600 leading / 2400 trailing samples
    _, (l, r) = dsp.trim_edges(y, top_db=40, frame_length=256, hop_length=64)
    if r <= l:
        return None, "silent"
    if l < 1600:
        y = np.concatenate([np.zeros(1600 - l), y])
        r += 1600 - l
        l = 1600
    if r > len(y) - 2400:
        y = np.concatenate([y, np.zeros(2400 - (len(y) - r))])
        r = len(y) - 2400
    y = y[l - 1600: r + 2400]
    if not 1 <= len(y) / sr <= 20:
        return None, "length"
    return y.astype(np.float32), None


def trim_audios(corpus_list=None, transformed=None):
    from scipy.io import wavfile as sciwav
    transformed = transformed or default_transformed
    for f in _corpus_dirs(transformed, corpus_list):
        corpus_name = os.path.basename(f)
        out_path = os.path.join(f, "proc_wavs")
        if os.path.exists(out_path):
            continue
        wavfiles = sorted(glob.glob(os.path.join(f, "wavs", "*.wav")))
        print(corpus_name, len(wavfiles), "files")
        os.makedirs(out_path, exist_ok=True)
        n_skip = n_gap = n_len = 0
        for wav_file in wavfiles:
            y = dsp.load_wav(wav_file, 16000)
            out, reason = trim_wav(y, corpus_name)
            if out is None:
                n_skip += 1
                if reason == "gap":
                    n_gap += 1
                elif reason == "length":
                    n_len += 1
                print("Skipped %s (%s)" % (os.path.basename(wav_file), reason))
                continue
            sciwav.write(os.path.join(out_path, os.path.basename(wav_file)),
                         16000, out)
        print("Total skipped %d files (%d for gap, %d for length)"
              % (n_skip, n_gap, n_len))


# ---------------------------------------------------------------------------
# stage 2: metadata recollection (reference process_corpus.py:128-174)
# ---------------------------------------------------------------------------


def recollect_meta(corpus_list=None, transformed=None):
    transformed = transformed or default_transformed
    for f in _corpus_dirs(transformed, corpus_list):
        meta = os.path.join(f, "metadata.csv")
        if not os.path.exists(meta):
            continue
        lines = open(meta, encoding="utf-8").read().splitlines()
        kept = []
        n_miss = n_dup = 0
        spk_samples = defaultdict(int)
        seen_texts = set()
        for line in lines:
            parts = line.split("|")
            if len(parts[0].split("_")) != 2:
                raise ValueError("%s: a name is SPEAKER_ID, got %r"
                                 % (meta, parts[0]))
            if (parts[1], parts[2]) in seen_texts:
                n_dup += 1
                continue
            seen_texts.add((parts[1], parts[2]))
            if os.path.exists(os.path.join(f, "proc_wavs",
                                           parts[0] + ".wav")):
                spk_samples[parts[0].split("_")[0]] += 1
                kept.append(parts)
            else:
                n_miss += 1

        thres = min_speaker_samples(os.path.basename(f))
        spk_to_remove = {s for s, n in spk_samples.items() if n < thres}
        out_lines = []
        n_skip = 0
        dur = 0.0
        for parts in kept:
            if parts[0].split("_")[0] in spk_to_remove:
                n_skip += 1
            else:
                dur += wav_duration(os.path.join(f, "proc_wavs",
                                                 parts[0] + ".wav"))
                out_lines.append("|".join(parts) + "\n")
        print("%s: total %d missing, %d skipped, %d dup, %d spk, "
              "%d spk skipped, %.2fh" % (
                  os.path.basename(f), n_miss, n_skip, n_dup,
                  len(spk_samples) - len(spk_to_remove), len(spk_to_remove),
                  dur / 3600))
        with open(meta, "w", encoding="utf-8") as fw:
            fw.writelines(out_lines)


# ---------------------------------------------------------------------------
# stage 3: mel building (reference process_corpus.py:226-241)
# ---------------------------------------------------------------------------


def _build_one_mel(args):
    wav_path, mel_path, hp_values = args
    hp = Config(**hp_values)
    wav = dsp.load_wav(wav_path, hp.sr)
    mel = dsp.get_spectrograms(wav, hp)
    np.save(mel_path, mel)
    return mel.shape[0]


def mel_batches(lengths, hp: Config, budget: int = MEL_BATCH_FRAMES):
    """Utterance indices in batches for the kernel's mels stage: in order,
    each batch as many as keep their 1 + length // hop frames within
    ``budget`` (one utterance at least)."""
    batches, batch, frames = [], [], 0
    for i, length in enumerate(lengths):
        n = 1 + length // hp.hop_length
        if batch and frames + n > budget:
            batches.append(batch)
            batch, frames = [], 0
        batch.append(i)
        frames += n
    return batches + [batch] if batch else batches


def _mel_jobs(corpus_dir):
    """(wav path, mel path) of every utterance in a corpus's metadata.csv;
    makes its ``mels`` directory."""
    os.makedirs(os.path.join(corpus_dir, "mels"), exist_ok=True)
    jobs = []
    with open(os.path.join(corpus_dir, "metadata.csv"),
              encoding="utf-8") as f:
        for line in f.read().splitlines():
            name = line.split("|")[0]
            jobs.append((os.path.join(corpus_dir, "proc_wavs", name + ".wav"),
                         os.path.join(corpus_dir, "mels", name + ".npy")))
    return jobs


def _fused_mels(jobs, hp: Config, device, workers: int) -> int:
    """One corpus's (wav path, mel path) jobs through ``fused_frame_mel``:
    batches from the wav headers' lengths (``mel_batches``), one
    ``melspectrogram_ragged`` call each (one kernel launch on a card; the
    plain version for a CPU device), each mel [1 + len // hop, n_mels]
    fp32 saved as .npy.  Threads read the next batch's wavs and save the
    mels while the current batch runs.  Returns the number of batches."""
    lengths = [round(wav_duration(wav) * hp.sr) for wav, _ in jobs]
    batches = mel_batches(lengths, hp, MEL_BATCH_FRAMES)
    with ThreadPoolExecutor(max(1, workers)) as pool:
        def read(batch):
            return [pool.submit(dsp.load_wav, jobs[i][0], hp.sr)
                    for i in batch]
        pending = read(batches[0]) if batches else []
        saved = []
        for k, batch in enumerate(batches):
            wavs = [torch.from_numpy(f.result()) for f in pending]
            if k + 1 < len(batches):
                pending = read(batches[k + 1])
            mels = dsp_torch.melspectrogram_ragged(wavs, hp, device)
            saved += [pool.submit(np.save, jobs[i][1], mel.numpy())
                      for i, mel in zip(batch, mels)]
        for f in saved:
            f.result()
    return len(batches)


def build_mels(corpus_list=None, transformed=None, hp: Config = None,
               workers: int = 0, device="cuda"):
    """Every corpus's ``proc_wavs`` -> ``mels/*.npy``.  On a CUDA
    ``device`` batches of utterances through the ``fused_frame_mel``
    kernel in this process (``_fused_mels``), raising where the card is
    missing; on the CPU numpy ``get_spectrograms`` per utterance, the
    reference's stage bit for bit, in a pool of ``workers`` processes
    (``spawn`` once CUDA has started in this process: a forked child
    inherits a context it cannot use)."""
    transformed = transformed or default_transformed
    hp = hp or default_config()
    device = resolve_device(device)
    for f in _corpus_dirs(transformed, corpus_list):
        if not os.path.exists(os.path.join(f, "metadata.csv")):
            continue
        jobs = _mel_jobs(f)
        if device.type != "cpu":
            n_batches = _fused_mels(jobs, hp, device, workers)
            print("%s: built %d mels in %d batches on %s" % (
                os.path.basename(f), len(jobs), n_batches, device))
            continue
        jobs = [job + (hp.values(),) for job in jobs]
        if workers > 1:
            ctx = multiprocessing.get_context("spawn") \
                if torch.cuda.is_initialized() else None
            with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
                list(ex.map(_build_one_mel, jobs, chunksize=16))
        else:
            for job in jobs:
                _build_one_mel(job)
        print("%s: built %d mels" % (os.path.basename(f), len(jobs)))


# ---------------------------------------------------------------------------
# stage 4: merge (reference process_corpus.py:296-348)
# ---------------------------------------------------------------------------


def merge_datasets(transformed=None, packed=None, corpus_order=None,
                   eval_per_language: int = 100):
    transformed = transformed or default_transformed
    packed = packed or default_packed
    corpus_order = corpus_order or include_corpus
    os.makedirs(packed, exist_ok=True)

    mel_zip = zipfile.ZipFile(os.path.join(packed, "mels.zip"), "w")
    lang_samples = defaultdict(list)
    lang_to_id = {}
    spk_to_id = {}

    for corpus in corpus_order:
        corpus_path = os.path.join(transformed, corpus)
        if not os.path.isdir(corpus_path):
            continue
        lines = [l.split("|") for l in
                 open(os.path.join(corpus_path, "metadata.csv"),
                      encoding="utf-8").read().splitlines()]
        lang = get_dataset_language(corpus)
        print(corpus, lang, "%d samples" % len(lines))
        if lang not in lang_to_id:
            lang_to_id[lang] = len(lang_to_id)
        for parts in lines:
            spk = parts[0].split("_")[0]
            if spk not in spk_to_id:
                spk_to_id[spk] = len(spk_to_id)
            mel = np.load(os.path.join(corpus_path, "mels",
                                       parts[0] + ".npy"))
            with io.BytesIO() as b:
                np.save(b, mel)
                mel_zip.writestr(parts[0] + ".npy", b.getvalue())
            lang_samples[lang].append("|".join(
                [parts[0] + ".npy", str(mel.shape[0]), parts[1], lang]))
    mel_zip.close()
    for name, ids in (("lang_id.json", lang_to_id),
                      ("spk_id.json", spk_to_id)):
        with open(os.path.join(packed, name), "w") as fw:
            json.dump(ids, fw, indent=1)

    print("Total %d langs" % len(lang_samples))
    train_samples, eval_samples = [], []
    for lang in lang_samples:
        lines = lang_samples[lang]
        print(lang, "%d samples" % len(lines))
        random.seed(0)
        random.shuffle(lines)
        ev, tr = lines[:eval_per_language], lines[eval_per_language:]
        tr.sort(key=lambda x: x.split("|")[0])
        ev.sort(key=lambda x: x.split("|")[0])
        train_samples.extend(tr)
        eval_samples.extend(ev)
    for name, rows in (("metadata.train.txt", train_samples),
                       ("metadata.eval.txt", eval_samples)):
        with open(os.path.join(packed, name), "w", encoding="utf-8") as fw:
            fw.write("\n".join(rows))


# ---------------------------------------------------------------------------
# stage 5: statistics (reference process_corpus.py:177-223)
# ---------------------------------------------------------------------------


def statistics(transformed=None, packed=None):
    transformed = transformed or default_transformed
    packed = packed or default_packed
    os.makedirs(packed, exist_ok=True)
    lang_stat = defaultdict(lambda: defaultdict(lambda: defaultdict(float)))
    for corpus in sorted(glob.glob(os.path.join(transformed, "*"))):
        if not os.path.isdir(corpus) or \
                os.path.basename(corpus) not in include_corpus:
            continue
        corpus_stat = defaultdict(lambda: defaultdict(float))
        meta = open(os.path.join(corpus, "metadata.csv"),
                    encoding="utf-8").read().splitlines()
        lang = get_dataset_language(os.path.basename(corpus))
        for m in meta:
            name, script, spk, _ = m.split("|")
            dur = wav_duration(os.path.join(corpus, "proc_wavs",
                                            name + ".wav"))
            lang_stat[lang][spk]["dur"] += dur
            lang_stat[lang][spk]["n"] += 1
            corpus_stat[spk]["dur"] += dur
            corpus_stat[spk]["n"] += 1
        total_dur = sum(s["dur"] for s in corpus_stat.values())
        total_n = sum(s["n"] for s in corpus_stat.values())
        print("%s: %d samples, %.2f h" % (os.path.basename(corpus), total_n,
                                          total_dur / 3600))

    rows = []
    for lang, spks in lang_stat.items():
        total_dur = sum(s["dur"] for s in spks.values())
        total_n = sum(s["n"] for s in spks.values())
        rows.append((lang, total_n, total_dur, len(spks)))
    rows.sort(key=lambda r: r[2], reverse=True)
    with open(os.path.join(packed, "lang_stat.tsv"), "w") as fw:
        for lang, n, dur, n_spk in rows:
            print("%s: %d samples, %.2f h, %d speakers" % (lang, n,
                                                           dur / 3600, n_spk))
            fw.write("%s\t%d\t%.2f\t%d\n" % (lang, n, dur / 3600, n_spk))


def collect_samples(transformed=None, out_dir=None, per_corpus: int = 5):
    """Copy a few random samples per corpus for spot checks
    (reference process_corpus.py:244-265)."""
    transformed = transformed or default_transformed
    out_dir = out_dir or os.path.join(os.path.dirname(transformed), "samples")
    os.makedirs(out_dir, exist_ok=True)
    samples = []
    for corpus in sorted(glob.glob(os.path.join(transformed, "*"))):
        if not os.path.isdir(corpus):
            continue
        meta = open(os.path.join(corpus, "metadata.csv"),
                    encoding="utf-8").read().splitlines()
        random.seed(0)
        random.shuffle(meta)
        for m in meta[:per_corpus]:
            samples.append(m)
            name = m.split("|")[0]
            src = os.path.join(corpus, "proc_wavs", name + ".wav")
            if not os.path.exists(src):
                src = os.path.join(corpus, "wavs", name + ".wav")
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name + ".wav"))
    samples.sort()
    open(os.path.join(out_dir, "metadata.csv"), "w",
         encoding="utf-8").write("\n".join(samples))


def check_duplicate_rate(transformed=None):
    """Report (speaker, text) duplicates per corpus
    (reference process_corpus.py:268-290)."""
    transformed = transformed or default_transformed
    for corpus in sorted(glob.glob(os.path.join(transformed, "*"))):
        if not os.path.isdir(corpus):
            continue
        meta = open(os.path.join(corpus, "metadata.csv"),
                    encoding="utf-8").read().splitlines()
        texts = defaultdict(list)
        spk_texts = defaultdict(list)
        for m in meta:
            parts = m.split("|")
            texts[parts[1]].append(parts)
            spk_texts[(parts[1], parts[2])].append(m)
        for key, v in spk_texts.items():
            if len(v) > 1:
                print("\n".join(v) + "\n")
        if len(texts) < len(meta) * 0.99:
            print(corpus, len(texts), len(meta), len(texts) / len(meta))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--stages", default="trim,meta,mels,merge,stats",
                        help="comma list of: trim,meta,mels,merge,stats")
    parser.add_argument("--corpora", default=None,
                        help="comma list of corpus names (default: all)")
    parser.add_argument("--transformed", default=None)
    parser.add_argument("--packed", default=None)
    parser.add_argument("--workers", type=int, default=os.cpu_count())
    parser.add_argument("--hparams", default="")
    parser.add_argument("--device", default="cuda",
                        help="device of the mels stage: cuda runs the "
                             "fused_frame_mel kernel, cpu the numpy stage")
    args = parser.parse_args(argv)
    corpus_list = args.corpora.split(",") if args.corpora else None
    hp = default_config().parse(args.hparams)
    stages = {
        "trim": lambda: trim_audios(corpus_list, args.transformed),
        "meta": lambda: recollect_meta(corpus_list, args.transformed),
        "mels": lambda: build_mels(corpus_list, args.transformed, hp,
                                   workers=args.workers, device=args.device),
        "merge": lambda: merge_datasets(args.transformed, args.packed),
        "stats": lambda: statistics(args.transformed, args.packed)}
    chosen = args.stages.split(",")
    for name, run in stages.items():
        if name in chosen:
            tic = time.perf_counter()
            run()
            print("%s stage: %.6f s" % (name, time.perf_counter() - tic),
                  flush=True)


if __name__ == "__main__":
    main()
