"""Convergence report of the port: the evidence that a training run on the
learnable synthetic corpus (``tools/make_learnable_corpus.py``) learned.

    python -m few_shot_transformer_tts_torch.convergence --run-dir RUN \
        --corpus CORPUS --out-dir OUT [--phase2-logdir LOGS] [--ckpt PATH] \
        [--device cuda]

The counterpart of ``tools/convergence_report.py``, on torch, numpy and the
port only.  ``RUN`` holds ``logs/`` (the train CLI's log dir: its
``outputs_*.log`` step lines and ``hparams.json``), ``models/`` (the
checkpoints) and ``eval_logs/`` (the eval service's ``metrics.jsonl``).
It reports:

  (a) the teacher-forced ``mse_loss`` window means over the first 20 and
      the last 100 logged steps;
  (b) per eval sample, the encoder-decoder attention's best head: the
      argmax input position of each decoded frame regressed on the frame
      index (the corpus pins 4 frames a character, a slope of 0.25), its
      R^2 and the attention mass within 3 positions of the fitted line;
  (c) the eval service's MSE-DTW per language over the checkpoints;
  (d) a deterministic AR decode of the final checkpoint against the ground
      truth, DTW-MSE per sample;
  (e) with ``--phase2-logdir``, the fr-fr share of the sampled rows per
      summary step from the trainer's ``counts/<lang>`` scalars.

The final checkpoint is decoded twice, on the eager frame loop and with
``use_pallas_decode=True`` (the fused ``decoder_frame_step``), and (b) and
(d) are reported for both, with each sample's two generated lengths and
the largest mel difference over their common frames.  ``summary.json``
holds the keys of the JAX report's (``converge_r05_flagship/summary.json``;
the eager decode) plus ``fused_decode`` and ``decode_agreement``.  Plots
are drawn only where matplotlib is installed.  ``--device`` defaults to
cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np

from .config import Config
from .data import FeederEval
from .models.tacotron import ByteToMel
from .train import checkpoint as ckpt_lib
from .utils import infolog
from .utils import metrics as metrics_lib
from .utils.device import resolve_device

STEP_RE = re.compile(
    r"\[Step (\d+)\] .*?loss=([\d.]+), mse_loss=([\d.]+)")
EVAL_LANGS = ("en-us", "de-de")


def parse_train_log(logdir):
    """[(step, loss, mse_loss)] from every ``outputs_*.log``, by step."""
    rows = []
    for path in sorted(glob.glob(os.path.join(logdir, "outputs_*.log"))):
        for line in open(path, errors="replace"):
            m = STEP_RE.search(line)
            if m:
                rows.append((int(m.group(1)), float(m.group(2)),
                             float(m.group(3))))
    rows.sort()
    return rows


def parse_eval_metrics(eval_logdir):
    """{lang: [(step, mse_dtw)]} from the eval service's metrics.jsonl."""
    out = {}
    path = os.path.join(eval_logdir, "metrics.jsonl")
    if not os.path.exists(path):
        return out
    for line in open(path):
        m = json.loads(line)
        if m["tag"].startswith("mse_dtw/"):
            out.setdefault(m["tag"].split("/", 1)[1], []).append(
                (m["step"], m["value"]))
    for v in out.values():
        v.sort()
    return out


def diagonality(align_bhqk, dec_len, enc_len, frames_per_char=4):
    """Best-head alignment linearity: per decoded frame take the argmax
    input position, regress position on frame index.  Returns dict with the
    best head's R^2, fitted slope (expected ~1/frames_per_char), and the
    fraction of attention mass within +-3 positions of the fitted line."""
    best = {"r2": -1.0}
    h_count = align_bhqk.shape[0]
    dec_len = min(dec_len, align_bhqk.shape[1])
    enc_len = min(enc_len, align_bhqk.shape[2])
    for h in range(h_count):
        a = align_bhqk[h, :dec_len, :enc_len]
        pos = np.argmax(a, axis=-1).astype(np.float64)
        t = np.arange(a.shape[0], dtype=np.float64)
        if dec_len < 8 or np.std(pos) < 0.5:
            # a head parked on one input position fits a constant with
            # R^2=1 trivially; it carries no alignment information
            continue
        slope, icept = np.polyfit(t, pos, 1)
        pred = slope * t + icept
        ss_res = np.sum((pos - pred) ** 2)
        ss_tot = np.sum((pos - pos.mean()) ** 2) + 1e-9
        r2 = 1.0 - ss_res / ss_tot
        cols = np.arange(enc_len)[None, :]
        near = np.abs(cols - pred[:, None]) <= 3.0
        mass = float((a * near).sum() / (a.sum() + 1e-9))
        if r2 > best["r2"]:
            best = {"r2": round(float(r2), 4),
                    "slope": round(float(slope), 4),
                    "head": h, "near_diag_mass": round(mass, 4)}
    return best


def parse_counts(logdir):
    """{step: {lang: rows sampled}} from the trainer's ``counts/<lang>``
    scalars."""
    per_step = {}
    path = os.path.join(logdir, "metrics.jsonl")
    if os.path.exists(path):
        for line in open(path):
            m = json.loads(line)
            if m["tag"].startswith("counts/"):
                per_step.setdefault(m["step"], {})[
                    m["tag"].split("/", 1)[1]] = m["value"]
    return per_step


def adapt_share(per_step, lang="fr-fr"):
    """{step: share of ``lang`` among the rows sampled in the window}."""
    return {str(s): round(per_step[s].get(lang, 0.0)
                          / max(1.0, sum(per_step[s].values())), 4)
            for s in sorted(per_step)}


def eval_batch(hp: Config, corpus: str):
    """The first eval batch of the corpus' en-us and de-de rows, in file
    order (as the JAX report batches them)."""
    with open(os.path.join(corpus, "lang_id.json")) as f:
        lang_to_id = json.load(f)
    with open(os.path.join(corpus, "spk_id.json")) as f:
        spk_to_id = json.load(f)
    feeder = FeederEval(
        os.path.join(corpus, "mels.zip"),
        os.path.join(corpus, "metadata.eval.txt"), hp,
        spk_to_id=spk_to_id, lang_to_id=lang_to_id,
        eval_lang=list(EVAL_LANGS), shuffle=False, keep_order=True,
        pick_partial=False, single=False)
    return feeder.fetch_data()[0]


def decode_report(model: ByteToMel, hp: Config, batch, fused: bool):
    """One deterministic decode of ``batch``: (per-sample rows of the
    best-head diagonality with DTW-MSE and lengths, the decode's results).
    ``fused`` decodes through ``decoder_frame_step``."""
    from .infer.synthesize import synthesize_batch
    results = synthesize_batch(model, batch, hp.replace(
        use_pallas_decode=fused), deterministic=True)
    dtw = metrics_lib.calculate_mse_dtw(
        results["mel_aft"], results["generated_lengths"],
        batch["mel_targets"], batch["target_lengths"])
    # encdec alignments come as [B, H, T_enc, T_dec] per layer (the
    # reference's plotting layout): frame-major here
    aligns = [np.asarray(a, np.float32).transpose(0, 1, 3, 2)
              for a in results["alignments"]["encdec"]]
    rows = []
    for i, name in enumerate(batch["names"]):
        gen_l = int(results["generated_lengths"][i])
        in_l = int(np.asarray(batch["input_lengths"])[i])
        best, best_layer = {"r2": -1.0}, 0
        for li, a in enumerate(aligns):
            d = diagonality(a[i], gen_l, in_l)
            if d["r2"] > best["r2"]:
                best, best_layer = d, li
        best["layer"] = best_layer
        best["name"] = str(name)
        best["dtw_mse"] = round(float(dtw[i]), 4)
        best["generated_frames"] = gen_l
        best["target_frames"] = int(np.asarray(batch["target_lengths"])[i])
        rows.append(best)
    results["aligns"] = aligns
    results["dtw"] = dtw
    return rows, results


def decode_agreement(eager, fused):
    """Per sample: both generated lengths and the largest |mel difference|
    over their common frames."""
    out = []
    for i in range(len(eager["generated_lengths"])):
        le = int(eager["generated_lengths"][i])
        lf = int(fused["generated_lengths"][i])
        n = min(le, lf)
        diff = float(np.max(np.abs(eager["mel_aft"][i, :n]
                                   - fused["mel_aft"][i, :n]))) if n else 0.0
        out.append({"eager_frames": le, "fused_frames": lf,
                    "max_abs_mel_diff": round(diff, 6)})
    return out


def checkpoint_report(ckpt: str, hp: Config, corpus: str, device):
    """Both decodes of ``ckpt`` (eager, fused) on the eval batch:
    {"batch", "eager": (rows, results), "fused": (rows, results),
    "agreement"}."""
    model = ByteToMel(hp, device=device)
    ckpt_lib.load_state(ckpt, model)
    model.eval()
    batch = eval_batch(hp, corpus)
    eager = decode_report(model, hp, batch, fused=False)
    fused = decode_report(model, hp, batch, fused=True)
    return {"batch": batch, "eager": eager, "fused": fused,
            "agreement": decode_agreement(eager[1], fused[1])}


def _mean_dtw(rows):
    return round(float(np.mean([r["dtw_mse"] for r in rows])), 4)


def _plot_loss(plt, out_dir, steps, mse):
    fig, ax = plt.subplots(figsize=(7, 3.2), dpi=110)
    ax.plot(steps, mse, lw=1.2, color="#4063d8")
    ax.set_yscale("log")
    ax.set_xlabel("step")
    ax.set_ylabel("teacher-forced mse_loss")
    ax.set_title("Training loss")
    ax.grid(alpha=0.25, lw=0.5)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "train_loss.png"))
    plt.close(fig)


def _plot_samples(plt, out_dir, batch, rows, results, n=2):
    """Ground truth, AR decode and the best head's alignment of the first
    ``n`` samples."""
    for i in range(min(n, len(batch["names"]))):
        name = str(batch["names"][i])
        gen_l = rows[i]["generated_frames"]
        tgt_l = rows[i]["target_frames"]
        in_l = int(np.asarray(batch["input_lengths"])[i])
        layer, head = rows[i].get("layer", 0), rows[i].get("head", 0)
        fig, axes = plt.subplots(3, 1, figsize=(7.5, 6.4), dpi=110)
        axes[0].imshow(np.asarray(batch["mel_targets"])[i][:tgt_l].T,
                       origin="lower", aspect="auto", cmap="magma",
                       vmin=-4, vmax=4)
        axes[0].set_title("%s ground truth (%d frames)" % (name, tgt_l))
        axes[1].imshow(results["mel_aft"][i][:gen_l].T, origin="lower",
                       aspect="auto", cmap="magma", vmin=-4, vmax=4)
        axes[1].set_title("AR decode (%d frames, DTW-MSE %.4f)"
                          % (gen_l, rows[i]["dtw_mse"]))
        axes[2].imshow(results["aligns"][layer][i, head, :gen_l, :in_l].T,
                       origin="lower", aspect="auto", cmap="viridis")
        axes[2].set_title("enc-dec attention L%d H%d (R2=%.3f)"
                          % (layer, head, rows[i]["r2"]))
        axes[2].set_xlabel("decoder frame")
        axes[2].set_ylabel("input position")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "sample_%d_%s.png" % (i, name)))
        plt.close(fig)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run-dir", required=True,
                    help="holds logs/, models/ and eval_logs/")
    ap.add_argument("--corpus", required=True,
                    help="the learnable corpus (make_learnable_corpus.py)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--phase2-logdir", default=None,
                    help="the adaptation phase's train log dir (the fr-fr "
                         "share from its counts/<lang> scalars)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint to decode (default: the latest in "
                         "run-dir/models)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; \"cpu\" to run there)")
    return ap


def main(argv=None):
    """Write ``summary.json`` (and the plots, with matplotlib) to the out
    dir; the summary."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    logdir = os.path.join(args.run_dir, "logs")
    with open(os.path.join(logdir, "hparams.json")) as f:
        hp = Config(**json.load(f))
    if device.type == "cpu":
        hp = hp.replace(use_bfloat16=False)
    plt = infolog._pyplot()

    # (a) the training loss
    rows = parse_train_log(logdir)
    if not rows:
        raise ValueError("no [Step] lines found in %s" % logdir)
    steps = np.array([r[0] for r in rows])
    mse = np.array([r[2] for r in rows])
    if plt is not None:
        _plot_loss(plt, args.out_dir, steps, mse)
    loss_summary = {
        "first_window_mse": round(float(np.mean(mse[:20])), 4),
        "last_window_mse": round(float(np.mean(mse[-100:])), 4),
        "steps": int(steps[-1]),
    }

    # (c) the eval service's MSE-DTW per checkpoint
    dtw_summary = {}
    for lang, series in sorted(parse_eval_metrics(
            os.path.join(args.run_dir, "eval_logs")).items()):
        s = np.array(series)
        dtw_summary[lang] = {"first": round(float(s[0, 1]), 4),
                             "last": round(float(s[-1, 1]), 4),
                             "n_ckpts": int(len(s)),
                             "monotone_decreasing_pairs": int(
                                 np.sum(np.diff(s[:, 1]) < 0))}

    # (b) + (d): both decodes of the final checkpoint
    ckpt = args.ckpt or ckpt_lib.find_ckpt(os.path.join(args.run_dir,
                                                        "models"))
    if ckpt is None:
        raise ValueError("no checkpoint under %s/models" % args.run_dir)
    report = checkpoint_report(ckpt, hp, args.corpus, device)
    eager_rows, eager_results = report["eager"]
    fused_rows, _ = report["fused"]
    if plt is not None:
        _plot_samples(plt, args.out_dir, report["batch"], eager_rows,
                      eager_results)

    # (e) the adaptation ramp
    ramp = None
    if args.phase2_logdir:
        ramp = adapt_share(parse_counts(args.phase2_logdir)) or None

    summary = {
        "checkpoint": os.path.relpath(ckpt, args.run_dir),
        "train_loss": loss_summary,
        "eval_mse_dtw": dtw_summary,
        "alignment_diagonality": eager_rows,
        "ar_decode_dtw_mse_mean": _mean_dtw(eager_rows),
        "adapt_ramp_fr_share": ramp,
        "fused_decode": {"alignment_diagonality": fused_rows,
                         "ar_decode_dtw_mse_mean": _mean_dtw(fused_rows)},
        "decode_agreement": report["agreement"],
    }
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
