"""Always-on eval service: checkpoint watcher with DTW-MSE and CER; the
counterpart of ``few_shot_transformer_tts_tpu/infer/evalservice.py``
(reference eval.py:62-218).

It scans the model dir for ``model.ckpt-<step>`` files and ``.d``
directories (filtered by start_step / eval_steps / eval_interval), loads
each in any format ``train/checkpoint.py:load_state`` reads (torch, the JAX
package's msgpack or sharded), synthesizes the eval batches with decoder
dropout on, saves mels and wavs through a worker pool, writes the DTW-MSE
against the ground-truth mels and (with ``azure_key.json``) the CER per
language to ``metrics.jsonl``, and mirrors its logs next to the
checkpoints.  One pass with ``--no_wait``; ``--recover_eval`` skips samples
that already have a ``_trim.wav``.  With ``--gpu_vocoder`` each batch is
vocoded on the card (``vocode_batch``) instead of per sample in numpy.
"""

from __future__ import annotations

import datetime
import glob
import json
import logging
import multiprocessing
import os
import signal
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from ..config import Config
from ..data import FeederEval
from ..frontend.text import language_vec_to_id
from ..models.tacotron import ByteToMel
from ..train import checkpoint as ckpt_lib
from ..train.loop import _mirror_logs
from ..utils import infolog, metrics
from ..utils.device import resolve_device
from .synthesize import save_eval_results, synthesize_batch, vocode_batch


def run_transcription(eval_path, names, existent_samples, meta_index,
                      cer_window, step):
    """Transcribe + cache in transcriptions.jsonl (reference eval.py:27-59)."""
    trans_path = os.path.join(eval_path, "transcriptions.jsonl")
    if os.path.exists(trans_path):
        with open(trans_path, encoding="utf-8") as f:
            lines = [json.loads(line) for line in f.read().splitlines()]
        found_names = [t["name"] for t in lines if t["DisplayText"]]
        transcribe_names = set(names + [n for n in existent_samples
                                        if n not in found_names])
        logging.info("Exist transcriptions skipped: %s",
                     str(set(found_names).difference(transcribe_names)))
        prev_trans = [t for t in lines
                      if t["name"] not in transcribe_names and t["DisplayText"]]
    else:
        transcribe_names = names + existent_samples
        prev_trans = []
    trans = []
    for n in transcribe_names:
        if n + ".npy" in meta_index:
            trans.append(metrics.transcribe(
                wav_path=os.path.join(eval_path, n + "_trim.wav"),
                meta=meta_index[n + ".npy"],
                id_to_lang=lambda x: x.replace("_", "-")))
    trans += prev_trans
    trans.sort(key=lambda x: x["name"])
    with open(trans_path, "w", encoding="utf-8") as fw:
        for t in trans:
            fw.write(json.dumps(t, ensure_ascii=False) + "\n")
    logging.info("[Step %d] Raw CER=%.3f", step,
                 float(np.mean([t["cer"] for t in trans])) if trans else 1.0)
    keys, values = [], []
    for t in trans:
        if "fail" not in t:
            keys.append(t["locale"])
            values.append(t["cer"])
        else:
            logging.warning("Failed sample: %s", t["name"])
    cer_window.update(keys, values)


def select_checkpoints(paths, finished, start_step: int, eval_steps,
                       eval_interval: int):
    """Filter checkpoint paths for evaluation (reference eval.py:130-143).

    A checkpoint is kept when its step suffix is numeric (a ``.d``
    directory's step before the suffix), it hasn't been evaluated yet, and
    either it is listed in ``eval_steps`` or (with no list) it clears
    ``start_step`` and falls on an ``eval_interval`` boundary.  Returns
    [(path, step)] sorted by step.
    """
    out = []
    for path in paths:
        step = path.split("-")[-1]
        if step.endswith(".d") and os.path.isdir(path):
            step = step[:-2]
        if path in finished or not step.isnumeric():
            continue
        step = int(step)
        if eval_steps and step in eval_steps:
            pass
        elif step < start_step or (eval_steps and step not in eval_steps) \
                or step % eval_interval != 0:
            continue
        out.append((path, step))
    out.sort(key=lambda x: x[-1])
    return out


def make_saver_pool(kind=None, workers: int = 5):
    """Worker pool for the Griffin-Lim, wav and plot saving.

    A process pool by default (reference eval.py:181-192: the work is CPU
    and GIL bound), ``kind="thread"`` for threads.  A child forked after
    CUDA has started inherits a CUDA context it cannot use and can hang,
    so once ``torch.cuda.is_initialized()`` the pool starts its workers
    with ``spawn`` (a fresh import each, paid once per eval pass), as the
    JAX package does for a non-CPU backend; otherwise the platform's
    default.  What is submitted is numpy only, and importing the port
    starts no CUDA context in a child.
    """
    if kind == "thread":
        return ThreadPoolExecutor(max_workers=workers)
    ctx = multiprocessing.get_context("spawn") \
        if torch.cuda.is_initialized() else None
    return ProcessPoolExecutor(max_workers=workers, mp_context=ctx)


def saver_pool_kind(executor) -> str:
    """'thread', or a process pool's start method."""
    if isinstance(executor, ThreadPoolExecutor):
        return "thread"
    return executor._mp_context.get_start_method()


def main(args, hp: Config):
    """The eval service (``python -m few_shot_transformer_tts_torch.eval``).
    Returns one record per evaluated checkpoint: its step, its format, the
    saver pool's kind, and wall seconds split into load, generation,
    vocoder, DTW and the wait for the saver pool after the last batch."""
    device = resolve_device(getattr(args, "device", "cuda"))
    logdir, model_dir, data_dir = args.log_dir, args.model_dir, args.data_dir
    # hung-process stack dumps, parity with reference eval.py:23-24
    if hasattr(signal, "SIGUSR1"):
        import faulthandler
        faulthandler.register(signal.SIGUSR1)
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "hparams.json"), "w") as f:
        json.dump(hp.values(), f, indent=1)
    with open(os.path.join(logdir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=1, default=str)
    time_id = datetime.datetime.now().strftime("%m%d_%H%M")
    infolog.set_logger(os.path.join(logdir, "outputs_%s.log" % time_id))
    writer = infolog.MetricWriter(logdir)

    def load_json(name):
        with open(os.path.join(data_dir, name)) as f:
            return json.load(f)

    eval_steps = [int(s) for s in args.eval_steps.split(":")] \
        if args.eval_steps else None
    lang_to_id = load_json("lang_id.json") if hp.multi_lingual else None
    spk_to_id = load_json("spk_id.json") if hp.multi_speaker else None
    # named key lists for the split flags, from the data dir as in the
    # port's train CLI
    filter_keys = load_json("filter_keys.json") if os.path.exists(
        os.path.join(data_dir, "filter_keys.json")) else {}

    def split_arg(v):
        if v in filter_keys:
            return filter_keys[v]
        return v.split(":") if v else None

    zipfilepath = args.zipfilepath or os.path.join(data_dir, "mels.zip")
    if not os.path.exists(zipfilepath):
        zipfilepath = None
    eval_meta = args.eval_meta or os.path.join(data_dir, "metadata.eval.txt")
    feeder_eval = FeederEval(
        zipfilepath, eval_meta, hp, spk_to_id=spk_to_id, lang_to_id=lang_to_id,
        eval_lang=split_arg(args.eval_languages),
        eval_spk=split_arg(args.eval_speakers),
        exclude_spk=split_arg(args.exclude_speakers),
        shuffle=True, keep_order=True, pick_partial=False, single=False)
    meta_index = {m["n"]: m for m in feeder_eval._metadata}
    id_to_lang = {v: k for k, v in lang_to_id.items()} \
        if hp.multi_lingual else None
    model = ByteToMel(hp, device=device)

    ckpt, finished_ckpt, retries, records = [], [], {}, []
    try:
        while True:
            if len(ckpt) == 0:
                logging.info("Scanning: %s", model_dir)
                ckpt = select_checkpoints(
                    glob.iglob(os.path.join(model_dir, "model.ckpt-*")),
                    finished_ckpt, args.start_step, eval_steps,
                    args.eval_interval)
            if len(ckpt) == 0:
                if args.no_wait:
                    logging.info("No more ckpt, exit")
                    return records
                logging.info("No ckpt found, sleeping...")
                time.sleep(args.scan_interval)
                continue

            tic = time.time()
            ckpt_path, step = ckpt[0]
            ckpt = ckpt[1:]
            try:
                fmt = ckpt_lib.checkpoint_format(ckpt_path)
                ckpt_lib.load_state(ckpt_path, model)
            except Exception:
                # a sharded .d dir can be seen mid-write (each shard file
                # is atomic, the set is not): retry on a short cadence for
                # ~10 minutes.  A checkpoint that never loads is given up
                # without sleeping, so later ones are not held behind it.
                traceback.print_exc()
                retries[ckpt_path] = retries.get(ckpt_path, 0) + 1
                retry_sleep = min(max(args.scan_interval, 1), 30)
                max_retries = max(3, int(600 // retry_sleep))
                if retries[ckpt_path] >= max_retries:
                    logging.error("Giving up on %s after %d failed loads",
                                  ckpt_path, retries[ckpt_path])
                    finished_ckpt.append(ckpt_path)
                else:
                    ckpt.insert(0, (ckpt_path, step))  # retry first
                    time.sleep(retry_sleep)
                continue
            model.eval()
            record = {"step": step, "format": fmt,
                      "load_s": time.time() - tic}
            records.append(record)
            record.update(_evaluate(args, hp, model, feeder_eval, meta_index,
                                    id_to_lang, zipfilepath, writer,
                                    os.path.join(logdir, "eval_%d" % step),
                                    step))
            record["total_s"] = time.time() - tic
            logging.info("Finished eval in %.3f sec (sample generation "
                         "%.3f): %s", record["total_s"],
                         record["generate_s"], json.dumps(record))
            # mirror eval logs next to the checkpoints (reference
            # eval.py:218)
            _mirror_logs(logdir, os.path.join(model_dir, "logs_eval"))
            finished_ckpt.append(ckpt_path)
    finally:
        writer.close()


def _evaluate(args, hp, model, feeder_eval, meta_index, id_to_lang,
              zipfilepath, writer, eval_path, step) -> dict:
    """One checkpoint's eval pass; its timings."""
    logging.info("Evaluating step %d", step)
    os.makedirs(eval_path, exist_ok=True)
    existent_samples = [os.path.split(f)[-1][:-len("_trim.wav")] for f in
                        glob.iglob(os.path.join(eval_path, "*_trim.wav"))]
    if len(existent_samples) == 0 or not args.recover_eval:
        batches = feeder_eval.fetch_data()
    else:
        logging.info("%d samples found and skipped", len(existent_samples))
        batches = feeder_eval.fetch_data(exclude=existent_samples)

    summary_windows = []
    if zipfilepath:
        mse = infolog.LookupWindow("mse_dtw", reduction="avg")
        summary_windows.append(mse)
    cer = infolog.LookupWindow("cer", reduction="avg")
    summary_windows.append(cer)

    logging.info("Running %d batches, to %s", len(batches), eval_path)
    batches = batches[:hp.max_eval_batches]
    executor = make_saver_pool(getattr(args, "saver_pool", None))
    times = {"pool": saver_pool_kind(executor), "batches": len(batches),
             "generate_s": 0.0, "vocoder_s": 0.0, "dtw_s": 0.0}
    eval_futures, names = [], []
    try:
        for i, batch in enumerate(batches):
            logging.info("[Batch %d] Generating %s", i, str(batch["names"]))
            tic = time.time()
            results = synthesize_batch(model, batch, hp, deterministic=False)
            times["generate_s"] += time.time() - tic
            results["mel_pre"] = None
            results["alignments"]["self"] = None
            if getattr(args, "gpu_vocoder", False):
                tic = time.time()
                results["wavs"] = vocode_batch(
                    results["mel_aft"], results["generated_lengths"], hp,
                    device=model.device)
                times["vocoder_s"] += time.time() - tic
            fn = partial(save_eval_results, **results, output_dir=eval_path,
                         hp=hp, save_trimmed_wave=True)
            logging.info("[Batch %d] Submit: %s", i, str(batch["names"]))
            eval_futures.append(executor.submit(fn))
            names.extend(batch["names"])

            if "input_language_vecs" in batch and id_to_lang is not None:
                lvs = np.asarray(batch["input_language_vecs"])
                langs = [id_to_lang[language_vec_to_id(lv)] for lv in
                         lvs[:len(batch["names"])]]
            else:
                langs = ["" for _ in batch["names"]]
            if zipfilepath:
                tic = time.time()
                mse.update(langs, metrics.calculate_mse_dtw(
                    results["mel_aft"], results["generated_lengths"],
                    batch["mel_targets"], batch["target_lengths"]))
                times["dtw_s"] += time.time() - tic
        tic = time.time()
        for f in eval_futures:
            f.result()
        times["save_s"] = time.time() - tic
    finally:
        executor.shutdown()
    times["samples"] = len(names)

    if metrics.transcribe_available():
        run_transcription(eval_path, names, existent_samples, meta_index,
                          cer, step)
    for window in summary_windows:
        for k, v in window.summary():
            writer.add_scalar(k, v, step)
        window.clear()
    return times
