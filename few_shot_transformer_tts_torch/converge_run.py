"""The port's convergence run on the learnable synthetic corpus, end to end:

    python -m few_shot_transformer_tts_torch.converge_run --work DIR \
        --out-dir OUT [--steps 12000] [--segments 3] [--adapt-steps 2000] \
        [--device cuda]

1. ``tools/make_learnable_corpus.py`` writes the corpus (660 train rows over
   en-us, de-de and the held-out fr-fr, 24 eval rows).
2. Phase 1: the train CLI (``python -m few_shot_transformer_tts_torch.train``)
   on en-us and de-de for ``--steps`` steps, a checkpoint every
   ``--checkpoint-interval``, run as ``--segments`` processes one after the
   other: each resumes from the latest checkpoint and feeder state, and its
   dropout draws come from (seed, step), so a segmented run is one run.  In
   each segment the eval service (``python -m
   few_shot_transformer_tts_torch.eval``) watches the model dir as a second
   process from the segment's first checkpoint on and scores every
   checkpoint as it lands; once the trainer has exited, the watcher is
   stopped after it has scored the segment's last checkpoint.
3. Phase 2 (``--adapt-steps``): a one-shot eval pass over the last
   checkpoint on all three languages, the train CLI again with
   ``--adapt_languages fr-fr`` (the fr-fr rate ramps from 0 to 0.3 over the
   phase's first ``--adapt-ramp`` steps), and a one-shot pass after it.
4. The report (``convergence.py``) of the last phase-1 checkpoint, with
   phase 2's fr-fr share, into ``OUT/summary.json``, and of the last
   checkpoint into ``OUT/adapt/summary.json``.

``--bars OUT`` holds a finished run's record to the bars of
CONVERGE_torch.md, on the CPU; a run ends with them in ``run.json``.
``OUT`` also gets the eval scalars of every pass (``eval_metrics_*.jsonl``),
the adaptation phase's ``counts/<lang>`` scalars (``adapt_counts.jsonl``),
every 10th ``[Step]`` line of each phase (``train_steps_sampled.log``,
``adapt_steps_sampled.log``) and ``run.json``: each segment's wall time and
s/step (the median over its logged steps, and apart over the steps that
ran while the watcher was scoring a checkpoint and while it was not), and
the eval service's seconds per checkpoint.  Checkpoints stay in ``--work``.
The data and schedule hparams are ``LEARNABLE_HPARAMS``; the widths are
the flagship's (``default_config()``) unless ``--hparams`` overrides them.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# converge_r05/hparams_cli.txt (the JAX package's convergence record)
# without its width keys, embed_size ... language_net_hidden
LEARNABLE_HPARAMS = (
    "warmup_steps=1500,max_lr=0.0007,lr_decay_step=40000,"
    "data_warmup_steps=0,target_length_lower_bound=0,"
    "target_length_upper_bound=2000,bucket_size=128,batch_frame_limit=6000,"
    "batch_frame_quad_limit=6000000,max_generation_frames=192,"
    "max_eval_batches=4,eval_sample_per_speaker=2,n_iter=8")
TRAIN_LANGS = "en-us:de-de"
# a trainer segment, or an eval pass, longer than this is stuck
PROCESS_TIMEOUT = 3600
ADAPT_LANG = "fr-fr"
FINAL_ADAPT_RATE = 0.3
STEP_RE = re.compile(r"^\[\w+ ([\d-]+ [\d:,]+)\] \[Step (\d+)\] ([\d.]+) "
                     r"sec/step .*?loss=([^,]+), mse_loss=([^ ]+)")
EVAL_DONE_RE = re.compile(r"^\[\w+ ([\d-]+ [\d:,]+)\] Finished eval in "
                          r"([\d.]+) sec .*?\"step\": (\d+)")


def write_corpus(corpus: str, *args) -> None:
    """The learnable corpus (``tools/make_learnable_corpus.py``, its
    defaults unless ``args`` say otherwise)."""
    subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                 "make_learnable_corpus.py"),
                    corpus, *args], check=True, capture_output=True,
                   timeout=300)


def train_argv(corpus, models, logs, max_steps, checkpoint_interval,
               hparams, device, seed=0, extra=()):
    """The train CLI's command line for one segment."""
    return [sys.executable, "-m", "few_shot_transformer_tts_torch.train",
            "--model-dir", models, "--log-dir", logs, "--data-dir", corpus,
            "--training_languages", TRAIN_LANGS, "--max_steps",
            str(max_steps), "--checkpoint_interval",
            str(checkpoint_interval), "--log_interval", "50", "--seed",
            str(seed), "--hparams", hparams, "--device", device,
            *extra]


def eval_argv(corpus, models, eval_logs, hparams, device, langs, *,
              start_step=0, eval_interval=1000, scan_interval=20,
              eval_steps=None, no_wait=False):
    """The eval service's command line: a watcher, or with ``no_wait`` one
    pass."""
    argv = [sys.executable, "-m", "few_shot_transformer_tts_torch.eval",
            "--model-dir", models, "--log-dir", eval_logs, "--data-dir",
            corpus, "--eval_languages", langs, "--start_step",
            str(start_step), "--eval_interval", str(eval_interval),
            "--scan_interval", str(scan_interval), "--hparams", hparams,
            "--device", device]
    if eval_steps is not None:
        argv += ["--eval_steps", str(eval_steps)]
    if no_wait:
        argv.append("--no_wait")
    return argv


def scored(path) -> dict:
    """{step: {lang: mse_dtw}} of an eval service's metrics file."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                m = json.loads(line)
                if m["tag"].startswith("mse_dtw/"):
                    out.setdefault(m["step"], {})[
                        m["tag"].split("/", 1)[1]] = m["value"]
    return out


def _stop(proc, grace=30):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(grace)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def run_segment(train_cmd, watch_cmd, eval_logs, ckpt_steps, langs,
                out_prefix, train_timeout, watch_tail=180):
    """The trainer and a watcher at once; after the trainer exits, the
    watcher until it has scored each of ``ckpt_steps`` for every language
    of ``langs`` (at most ``watch_tail`` s more).  Both processes are
    stopped on any exit.  Raises when the trainer fails or a checkpoint
    goes unscored.  Returns the wall seconds of the trainer and of the
    watcher's tail."""
    procs = []
    try:
        with open(out_prefix + "_eval.out", "w") as eval_out, \
                open(out_prefix + "_train.out", "w") as train_out:
            tic = time.time()
            procs.append(subprocess.Popen(watch_cmd, cwd=ROOT,
                                          stdout=eval_out,
                                          stderr=subprocess.STDOUT))
            procs.append(subprocess.Popen(train_cmd, cwd=ROOT,
                                          stdout=train_out,
                                          stderr=subprocess.STDOUT))
            rc = procs[1].wait(train_timeout)
            train_s = time.time() - tic
            if rc != 0:
                raise RuntimeError("the trainer exited with %d; see %s"
                                   % (rc, out_prefix + "_train.out"))
            tic = time.time()
            want = set(langs.split(":"))
            while True:
                have = scored(os.path.join(eval_logs, "metrics.jsonl"))
                if all(want <= set(have.get(s, {})) for s in ckpt_steps):
                    break
                if procs[0].poll() is not None or \
                        time.time() - tic > watch_tail:
                    raise RuntimeError(
                        "the watcher scored %s of checkpoints %s; see %s"
                        % (sorted(have), list(ckpt_steps),
                           out_prefix + "_eval.out"))
                time.sleep(1)
            return train_s, time.time() - tic
    finally:
        for p in procs:
            _stop(p)


def run_pass(cmd, out_path, timeout):
    """One ``--no_wait`` eval pass as its own process."""
    with open(out_path, "w") as out:
        subprocess.run(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                       check=True, timeout=timeout)


def _stamp(text):
    return datetime.datetime.strptime(text, "%Y-%m-%d %H:%M:%S,%f") \
        .timestamp()


def step_lines(logdir):
    """[(time, step, sec/step, loss, mse_loss, line)] of every ``[Step]``
    line of a train log dir, by step (the losses as floats: nan and inf
    included)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(logdir, "outputs_*.log"))):
        with open(path, errors="replace") as f:
            for line in f:
                m = STEP_RE.match(line)
                if m:
                    rows.append((_stamp(m.group(1)), int(m.group(2)),
                                 float(m.group(3)), float(m.group(4)),
                                 float(m.group(5)), line.rstrip("\n")))
    rows.sort(key=lambda r: r[1])
    return rows


def eval_intervals(eval_logs):
    """[(start, end, seconds, step)] of each checkpoint the eval service
    scored (its ``Finished eval`` lines)."""
    out = []
    for path in sorted(glob.glob(os.path.join(eval_logs, "outputs_*.log"))):
        with open(path, errors="replace") as f:
            for line in f:
                m = EVAL_DONE_RE.match(line)
                if m:
                    end, sec = _stamp(m.group(1)), float(m.group(2))
                    out.append((end - sec, end, sec, int(m.group(3))))
    return out


def step_seconds(rows, busy=(), first=1, last=None):
    """Median s/step of the logged steps in [first, last]; and apart, of
    those whose log burst overlapped an eval interval of ``busy`` and of
    the others.  A burst spans from the previous burst's time to its own
    (every step of a ``log_interval`` window is logged at once)."""
    sel = [r for r in rows if r[1] >= first and (last is None or
                                                 r[1] <= last)]
    during, apart = [], []
    prev = None
    for i, r in enumerate(sel):
        start = prev if prev is not None else r[0] - r[2]
        if any(s < r[0] and e > start for s, e, _, _ in busy):
            during.append(r[2])
        else:
            apart.append(r[2])
        if i + 1 < len(sel) and sel[i + 1][0] != r[0]:
            prev = r[0]
    med = lambda v: float(np.median(v)) if v else None
    return {"median": med([r[2] for r in sel]), "steps": len(sel),
            "median_watcher_scoring": med(during),
            "steps_watcher_scoring": len(during),
            "median_watcher_idle": med(apart), "steps_watcher_idle":
            len(apart)}


def window_mse(rows, first, last):
    """Mean teacher-forced mse_loss of the logged steps in [first, last]."""
    v = [r[4] for r in rows if first <= r[1] <= last]
    return float(np.mean(v)) if v else math.nan


def nvidia_smi() -> str:
    """The card's name and power limit, or what stood in the way."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return "not read: %r" % e


def _sample(rows, path, every=10):
    with open(path, "w") as f:
        for r in rows:
            if r[1] % every == 1 or every == 1:
                f.write(r[5] + "\n")


def _copy_tags(src, dst, prefix=None):
    if os.path.exists(src):
        with open(src) as f, open(dst, "w") as out:
            for line in f:
                if prefix is None or json.loads(line)["tag"].startswith(
                        prefix):
                    out.write(line)


def bars(out_dir) -> dict:
    """The run's record held to its bars (CONVERGE_torch.md): for each,
    the value, the bar and whether it is met.  Reads ``run.json``, both
    summaries and the copied scalars of ``out_dir``."""
    with open(os.path.join(out_dir, "run.json")) as f:
        record = json.load(f)
    steps, adapt_steps = record["steps"], record["adapt_steps"]
    with open(os.path.join(out_dir, "summary.json")) as f:
        summary = json.load(f)
    out = {}

    def bar(name, value, text, met):
        out[name] = {"value": value, "bar": text, "met": bool(met)}

    window = record["phase1"]["last_window_mse"]
    bar("last_100_mse_window", window, "<= 0.0045", window <= 0.0045)
    for path, rows in (("eager", summary["alignment_diagonality"]),
                       ("fused", summary["fused_decode"][
                           "alignment_diagonality"])):
        dtw = [r["dtw_mse"] for r in rows]
        n = sum(d <= 0.0035 for d in dtw)
        bar("decode_%s_at_floor" % path,
            {"samples_at_most_0.0035": n, "samples": len(dtw),
             "dtw_min": min(dtw), "dtw_max": max(dtw)},
            ">= 14 of 16 at DTW-MSE <= 0.0035", n >= 14)
        r2 = float(np.median([r["r2"] for r in rows]))
        slopes = [r.get("slope") for r in rows]
        n_slope = sum(s is not None and 0.24 <= s <= 0.26 for s in slopes)
        bar("alignment_%s" % path,
            {"r2_median": r2, "slopes_in_0.24_0.26": n_slope,
             "samples": len(rows)},
            "R2 median >= 0.95 and slope 0.24-0.26 on >= 14 of 16",
            r2 >= 0.95 and n_slope >= 14)
    phase1 = scored(os.path.join(out_dir, "eval_metrics_phase1.jsonl"))
    want = range(record.get("checkpoint_interval", 1000), steps + 1,
                 record.get("checkpoint_interval", 1000))
    scored_all = all(set(TRAIN_LANGS.split(":")) <= set(phase1.get(s, {}))
                     and all(np.isfinite(v) for v in phase1[s].values())
                     for s in want)
    bar("watcher_scored_every_checkpoint",
        {"scored": sorted(phase1), "checkpoints": len(want)},
        "every phase-1 checkpoint, finite", scored_all)
    if not adapt_steps:
        return out
    ramp_end = steps + record.get("adapt_ramp", 1000)
    shares = summary["adapt_ramp_fr_share"] or {}
    first = shares[min(shares, key=int)] if shares else None
    after = [v for k, v in shares.items() if int(k) > ramp_end]
    lo, hi = (min(after), max(after)) if after else (None, None)
    bar("fr_share", {"first_window": first, "after_ramp_min": lo,
                     "after_ramp_max": hi},
        "< 0.02 in the first window, 0.27-0.33 after the ramp",
        first is not None and first < 0.02 and after and 0.27 <= lo and
        hi <= 0.33)
    fr = {name: v[ADAPT_LANG] for name in ("pre", "post")
          for v in scored(os.path.join(
              out_dir, "eval_metrics_%sadapt.jsonl" % name)).values()}
    bar("fr_mse_dtw", fr, "falls >= 10x to <= 0.05",
        fr["post"] <= 0.05 and fr["pre"] >= 10 * fr["post"])
    with open(os.path.join(out_dir, "adapt", "summary.json")) as f:
        adapt = json.load(f)
    per_lang = {}
    for r in adapt["alignment_diagonality"]:
        lang = "en-us" if r["name"].startswith("en") else "de-de"
        per_lang.setdefault(lang, []).append(r["dtw_mse"])
    med = {k: float(np.median(v)) for k, v in sorted(per_lang.items())}
    bar("base_languages_after_adaptation", med,
        "median deterministic DTW-MSE <= 0.005 for en-us and de-de",
        all(v <= 0.005 for v in med.values()))
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", help="corpus, checkpoints and logs (large)")
    ap.add_argument("--out-dir",
                    help="the record: metrics, sampled logs, summaries")
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--checkpoint-interval", type=int, default=1000)
    ap.add_argument("--segments", type=int, default=3)
    ap.add_argument("--adapt-steps", type=int, default=2000)
    ap.add_argument("--adapt-ramp", type=int, default=1000)
    ap.add_argument("--scan-interval", type=int, default=20)
    ap.add_argument("--summary-interval", type=int, default=100,
                    help="steps between the trainer's scalars (counts)")
    ap.add_argument("--hparams", default="",
                    help="overrides after LEARNABLE_HPARAMS (widths)")
    ap.add_argument("--corpus-args", default="",
                    help="make_learnable_corpus.py flags (space-separated)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the train CLI's --seed: weights and dropout draws")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bars", default=None, metavar="OUT",
                    help="only hold a finished run's record in OUT to its "
                         "bars (no card needed), print them and exit")
    return ap


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.bars:
        result = bars(args.bars)
        print(json.dumps(result, indent=1))
        return result
    if not (args.work and args.out_dir):
        parser.error("--work and --out-dir are needed for a run")
    from .utils.device import resolve_device
    resolve_device(args.device)
    work, out = os.path.abspath(args.work), os.path.abspath(args.out_dir)
    os.makedirs(work, exist_ok=True)
    os.makedirs(out, exist_ok=True)
    corpus = os.path.join(work, "corpus")
    run = os.path.join(work, "run")
    models = os.path.join(run, "models")
    logs = os.path.join(run, "logs")
    eval_logs = os.path.join(run, "eval_logs")
    hparams = LEARNABLE_HPARAMS + ("," + args.hparams if args.hparams
                                   else "")
    summary = ("--summary_interval", str(args.summary_interval))
    record = {"nvidia_smi": nvidia_smi(), "seed": args.seed,
              "hparams": hparams, "steps": args.steps,
              "checkpoint_interval": args.checkpoint_interval,
              "segments": [], "adapt_steps": args.adapt_steps,
              "adapt_ramp": args.adapt_ramp}

    def save_record():
        with open(os.path.join(out, "run.json"), "w") as f:
            json.dump(record, f, indent=1)

    tic = time.time()
    write_corpus(corpus, *args.corpus_args.split())
    record["corpus_s"] = time.time() - tic

    # phase 1, in segments
    ival = args.checkpoint_interval
    ends = [int(round(args.steps * (k + 1) / args.segments / ival)) * ival
            for k in range(args.segments)]
    start = 0
    for k, end in enumerate(ends):
        ckpts = list(range(start + ival, end + 1, ival))
        train_s, tail_s = run_segment(
            train_argv(corpus, models, logs, end, ival, hparams, args.device,
                       args.seed, summary),
            eval_argv(corpus, models, eval_logs, hparams, args.device,
                      TRAIN_LANGS, start_step=start + ival,
                      eval_interval=ival, scan_interval=args.scan_interval),
            eval_logs, ckpts, TRAIN_LANGS,
            os.path.join(work, "segment%d" % k), PROCESS_TIMEOUT)
        rows = step_lines(logs)
        busy = eval_intervals(eval_logs)
        record["segments"].append({
            "first_step": start + 1, "last_step": end, "train_s": train_s,
            "watch_tail_s": tail_s,
            "s_per_step": step_seconds(rows, busy, start + 1, end)})
        _sample(rows, os.path.join(out, "train_steps_sampled.log"))
        _copy_tags(os.path.join(eval_logs, "metrics.jsonl"),
                   os.path.join(out, "eval_metrics_phase1.jsonl"))
        save_record()
        start = end

    rows = step_lines(logs)
    busy = eval_intervals(eval_logs)
    record["phase1"] = {
        "s_per_step_from_100": step_seconds(rows, busy, 100, args.steps),
        "eval_s_per_checkpoint": [[s, sec] for _, _, sec, s in busy],
        "first_window_mse": float(np.mean([r[4] for r in rows[:20]])),
        "last_window_mse": float(np.mean([r[4] for r in rows[-100:]])),
        "all_losses_finite": bool(all(np.isfinite(r[3]) and
                                      np.isfinite(r[4]) for r in rows)),
        "logged_steps": len(rows)}
    save_record()

    # phase 2: the held-out language, a pass before and after
    langs = "%s:%s" % (TRAIN_LANGS, ADAPT_LANG)
    final = args.steps
    if args.adapt_steps:
        tic = time.time()
        run_pass(eval_argv(corpus, models, os.path.join(run, "eval_pre"),
                           hparams, args.device, langs,
                           eval_steps=args.steps, no_wait=True),
                 os.path.join(work, "eval_pre.out"), PROCESS_TIMEOUT)
        record["preadapt_pass_s"] = time.time() - tic
        final = args.steps + args.adapt_steps
        adapt_logs = os.path.join(run, "logs_adapt")
        adapt = ("%s,adapt_start_step=%d,adapt_end_step=%d,"
                 "final_adapt_rate=%s" % (hparams, args.steps,
                                          args.steps + args.adapt_ramp,
                                          FINAL_ADAPT_RATE))
        tic = time.time()
        with open(os.path.join(work, "adapt_train.out"), "w") as f:
            subprocess.run(train_argv(corpus, models, adapt_logs, final,
                                      ival, adapt, args.device, args.seed,
                                      summary + ("--adapt_languages",
                                                 ADAPT_LANG)),
                           cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                           check=True, timeout=PROCESS_TIMEOUT)
        arows = step_lines(adapt_logs)
        record["adapt"] = {"train_s": time.time() - tic,
                           "s_per_step": step_seconds(arows),
                           "all_losses_finite": bool(all(
                               np.isfinite(r[3]) and np.isfinite(r[4])
                               for r in arows)),
                           "logged_steps": len(arows)}
        _sample(arows, os.path.join(out, "adapt_steps_sampled.log"))
        _copy_tags(os.path.join(adapt_logs, "metrics.jsonl"),
                   os.path.join(out, "adapt_counts.jsonl"), "counts/")
        tic = time.time()
        run_pass(eval_argv(corpus, models, os.path.join(run, "eval_post"),
                           hparams, args.device, langs, eval_steps=final,
                           no_wait=True),
                 os.path.join(work, "eval_post.out"), PROCESS_TIMEOUT)
        record["postadapt_pass_s"] = time.time() - tic
        for name in ("pre", "post"):
            _copy_tags(os.path.join(run, "eval_" + name, "metrics.jsonl"),
                       os.path.join(out, "eval_metrics_%sadapt.jsonl"
                                    % name))
        save_record()

    # the report: phase 1's last checkpoint, then the last one
    from . import convergence
    tic = time.time()
    report = ["--run-dir", run, "--corpus", corpus, "--device", args.device]
    if args.adapt_steps:
        report += ["--phase2-logdir", os.path.join(run, "logs_adapt")]
    convergence.main(report + ["--out-dir", out, "--ckpt", os.path.join(
        models, "model.ckpt-%d" % args.steps)])
    if args.adapt_steps:
        convergence.main(report + ["--out-dir", os.path.join(out, "adapt"),
                                   "--ckpt", os.path.join(
                                       models, "model.ckpt-%d" % final)])
    record["report_s"] = time.time() - tic
    record["tmp_files_left"] = sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(models, "*.tmp")))
    save_record()
    record["bars"] = bars(out)
    save_record()
    return record


if __name__ == "__main__":
    main()
