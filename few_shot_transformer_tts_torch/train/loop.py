"""Training runtime of the port: the train step and the host loop.

Counterpart of ``few_shot_transformer_tts_tpu/train/loop.py`` (reference
train.py:25-249) for one process on one device.  The step is eager PyTorch:
forward with dropout, ``compute_loss``, backward (through the attention and
LayerNorm backward kernels on the card), an Adam step (with
``hp.use_fused_adam``, through the fused Adam kernel), and the BatchNorm
running statistics (updated in the forward).  The host loop keeps the
reference's cadence: windowed sec/step and loss logging, scalars every
summary_interval, checkpoint + feeder state every checkpoint_interval (the
checkpoint through ``AsyncCheckpointer``: the host copy on the step's thread,
the write on a writer thread), inline eval, and a state save on a crash or
SIGTERM.

As in the JAX package, the losses stay on the device and are fetched every
``log_interval`` steps (and at each summary/checkpoint/eval/stop boundary)
in one transfer, so the host does not wait on the card every step; every
step still gets its own log line.  Each step's dropout draws come from a
generator seeded from (seed, step), so a resumed run draws the same masks.
After each checkpoint has landed the log dir is mirrored to
``<model_dir>/logs`` (``_mirror_logs``, rsync, best effort).

With ``--multihost`` (one process per GPU under ``torchrun``) the step runs
under ``DistributedDataParallel`` and keeps the JAX step's semantics over the
global batch: each rank trains on its own ``[rank::world]`` rows, the
masked means and the postnet's BatchNorm statistics are all-reduced over
the ranks (``compute_loss`` and ``MaskedBatchNorm`` with the group of
``parallel.mesh.make_stats_group``), and every checkpoint is the sharded
``model.ckpt-<step>.d`` (each rank its own leaves and ``feeder_<rank>.pkl``).
Rank 0 alone writes the logs, the metrics and the inline eval.  The JAX
package's profiler hooks are not ported.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import shutil
import signal
import subprocess
import time
import traceback
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..frontend.text import language_vec_to_id
from ..models.tacotron import ByteToMel, compute_loss, init_weights_, \
    lr_factor
from ..parallel import mesh as mesh_lib
from ..utils import infolog
from ..utils.device import resolve_device
from . import checkpoint as ckpt_lib

_BATCH_KEYS = ("inputs", "input_lengths", "mel_targets", "target_lengths",
               "input_spk_ids", "input_language_vecs")
_SCALAR_KEYS = ("loss", "bef_loss", "aft_loss", "mse_loss", "l2",
                "stop_loss")


def make_optimizer(model: torch.nn.Module, hp: Config):
    """Adam(eps=5e-8) with the reference LR schedule (reference
    train.py:130-131, tacotron.py:176-179) as a LambdaLR: the LR of a step
    is the schedule at the pre-increment count.  ``hp.use_fused_adam``
    selects ``ops/fused_adam.py:FusedAdam`` (the ``fused_adam_step``
    kernel on the leaves the JAX package routes to it, as its
    ``make_train_step`` does for replicated state, which is the port's only
    kind); otherwise ``torch.optim.Adam`` takes its foreach path.  Both
    keep one state-dict layout, so checkpoints move between them."""
    kw = dict(lr=hp.max_lr, betas=(hp.adam_beta1, hp.adam_beta2),
              eps=hp.adam_eps)
    if hp.use_fused_adam:
        from ..ops.fused_adam import FusedAdam, kernel_leaf_params
        optimizer = FusedAdam(model.parameters(),
                              kernel_params=kernel_leaf_params(model), **kw)
    else:
        optimizer = torch.optim.Adam(model.parameters(), foreach=True, **kw)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda s: lr_factor(s, hp))
    return optimizer, scheduler


def quantize_wire_mels(batch: Dict, hp: Config) -> Dict:
    """Mel targets as int16 for the host->device copy (``hp.wire_mel_int16``):
    step max_abs_value/32767 ~= 1.2e-4 on the [-4, 4] mel scale; values
    beyond +-max_abs_value are clipped."""
    m = batch.get("mel_targets")
    if m is None or m.dtype == np.int16:
        return batch
    scale = 32767.0 / float(hp.max_abs_value)
    q = np.clip(np.asarray(m, np.float32) * scale, -32767, 32767)
    out = dict(batch)
    out["mel_targets"] = np.round(q).astype(np.int16)
    return out


def dequantize_wire_mels(batch: Dict, hp: Config) -> Dict:
    m = batch.get("mel_targets")
    if m is None or m.dtype != torch.int16:
        return batch
    out = dict(batch)
    out["mel_targets"] = m.float() * (float(hp.max_abs_value) / 32767.0)
    return out


def device_batch(batch: Dict, hp: Config, device) -> Dict[str, torch.Tensor]:
    """The model inputs of a feeder batch on ``device`` (mels through the
    int16 wire when ``hp.wire_mel_int16``)."""
    host = {k: batch[k] for k in _BATCH_KEYS if k in batch}
    if hp.wire_mel_int16:
        host = quantize_wire_mels(host, hp)
    out = {k: torch.from_numpy(np.asarray(v)).to(device)
           for k, v in host.items()}
    return dequantize_wire_mels(out, hp)


def step_generator(seed: int, step: int, device, rank: int = 0
                   ) -> torch.Generator:
    """The dropout generator of one step on ``device``: a pure function of
    (seed, step), with the rank folded in on ranks other than 0, so that
    data-parallel ranks draw different masks (torch dropout and the
    attention kernels' Philox seeds both come from it)."""
    entropy = [seed, step] if rank == 0 else [seed, step, rank]
    hi, lo = np.random.SeedSequence(entropy).generate_state(2)
    gen = torch.Generator(device)
    gen.manual_seed(((int(hi) << 32) | int(lo)) & (2 ** 63 - 1))
    return gen


def train_step(model: ByteToMel, optimizer, scheduler,
               batch: Dict[str, torch.Tensor], hp: Config,
               generator: torch.Generator, group=None) -> Dict:
    """One step: forward (train mode), loss, backward, Adam, schedule.
    Returns the losses as device tensors (no host sync) and ``lr``, the LR
    this step applied.  ``model`` may be the DDP-wrapped model; ``group``
    (data parallel at world > 1) makes the losses and BatchNorm statistics
    those of every rank's rows (``compute_loss``)."""
    model.train()
    outputs = model(batch["inputs"], batch["input_lengths"],
                    batch["mel_targets"], batch["target_lengths"],
                    batch.get("input_spk_ids"),
                    batch.get("input_language_vecs"), train=True,
                    generator=generator, group=group)
    losses = compute_loss(model, batch["mel_targets"],
                          batch["target_lengths"], outputs, hp, group)
    optimizer.zero_grad(set_to_none=True)
    losses.pop("objective", losses["loss"]).backward()
    lr = optimizer.param_groups[0]["lr"]
    optimizer.step()
    scheduler.step()
    out = {k: v.detach() for k, v in losses.items()}
    out["lr"] = lr
    return out


# ---------------------------------------------------------------------------
# host training loop (reference train.py:25-249)
# ---------------------------------------------------------------------------


def train(args, hp: Config):
    """The training run of ``python -m few_shot_transformer_tts_torch.train``.
    Returns (model, global_step); the model is the unwrapped module."""
    from ..data import Feeder, FeederEval
    from ..data.metadata import parse_downsample_spec

    if getattr(args, "multihost", False):
        device = mesh_lib.init_distributed(
            args.dist_backend or default_backend(args.device), args.device)
    else:
        device = resolve_device(args.device)
    rank, world = mesh_lib.process_index(), mesh_lib.process_count()
    mesh_lib.check_mesh(hp, world)
    logdir, model_dir, data_dir = args.log_dir, args.model_dir, args.data_dir
    time_id = datetime.datetime.now().strftime("%m%d_%H%M")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(logdir, exist_ok=True)
    writer = None
    if rank == 0:
        infolog.set_logger(os.path.join(logdir, "outputs_%s.log" % time_id))
        writer = infolog.MetricWriter(logdir)
        with open(os.path.join(logdir, "hparams.json"), "w") as f:
            json.dump(hp.values(), f, indent=1)
        with open(os.path.join(logdir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=1, default=str)
    else:
        infolog.set_logger(name="rank %d" % rank)
    logging.info("Training on %s, process %d/%d", device, rank, world)

    eval_steps = [int(s) for s in args.eval_steps.split(":")] \
        if args.eval_steps else None

    def load_json(name):
        with open(os.path.join(data_dir, name)) as f:
            return json.load(f)

    lang_to_id = load_json("lang_id.json") if hp.multi_lingual else None
    spk_to_id = load_json("spk_id.json") if hp.multi_speaker else None
    # named key lists for the split flags (the reference reads them from
    # the working directory; the port from the data dir)
    filter_keys = load_json("filter_keys.json") if os.path.exists(
        os.path.join(data_dir, "filter_keys.json")) else {}

    def split_arg(v):
        if v in filter_keys:
            return filter_keys[v]
        return v.split(":") if v else None

    zipfilepath = args.zipfilepath or os.path.join(data_dir, "mels.zip")
    train_meta = args.train_meta or os.path.join(data_dir,
                                                 "metadata.train.txt")
    eval_meta = args.eval_meta or os.path.join(data_dir, "metadata.eval.txt")

    feeder = Feeder(
        zipfilepath, train_meta, hparams=hp, spk_to_id=spk_to_id,
        lang_to_id=lang_to_id, rank=rank, world_size=world,
        adapt_lang=split_arg(args.adapt_languages),
        adapt_spk=split_arg(args.adapt_speakers),
        train_lang=split_arg(args.training_languages),
        train_spk=split_arg(args.training_speakers),
        exclude_spk=split_arg(args.exclude_speakers),
        downsample_lang=parse_downsample_spec(args.downsample_languages),
        adapt_samples=split_arg(args.adapt_samples),
        warmup_lang=split_arg(args.warmup_languages),
        warmup_spk=split_arg(args.warmup_speakers))
    feeder_eval = None
    if rank == 0:
        feeder_eval = FeederEval(
            zipfilepath, eval_meta, hp, spk_to_id=spk_to_id,
            lang_to_id=lang_to_id, eval_lang=split_arg(args.eval_languages),
            eval_spk=split_arg(args.eval_speakers),
            exclude_spk=split_arg(args.exclude_speakers), shuffle=True,
            keep_order=True, pick_partial=True, single=False)

    model = init_weights_(ByteToMel(hp, device=device), args.seed)
    optimizer, scheduler = make_optimizer(model, hp)

    global_step = 0
    if args.restore_from:
        global_step = ckpt_lib.load_state(args.restore_from, model,
                                          optimizer, scheduler)
        logging.info("Restore from %s, step %d", args.restore_from,
                     global_step)
    latest = ckpt_lib.find_ckpt(model_dir)
    if latest:
        global_step = ckpt_lib.load_state(latest, model, optimizer,
                                          scheduler)
        logging.info("Restore from previous run at %s from %s, step %d",
                     model_dir, latest, global_step)
    ckpt_lib.maybe_load_feeder_state(logdir, rank, feeder)

    # the step's module: DDP over the process group when there is one (its
    # hooks average the gradients); checkpoints and eval take the model
    step_model, group = model, None
    if torch.distributed.is_initialized():
        group = mesh_lib.make_stats_group()
        step_model = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None, broadcast_buffers=False)

    feeder.global_step = global_step
    feeder.start()
    logging.info("Model parameters: %d",
                 sum(p.numel() for p in model.parameters()))

    time_window = infolog.ValueWindow(100)
    loss_window = infolog.ValueWindow(100)
    summary_windows = []
    id_to_lang = None
    if hp.multi_lingual:
        id_to_lang = {v: k for k, v in lang_to_id.items()}
        counts = infolog.LookupWindow("counts", reduction="total")
        aft_losses = infolog.LookupWindow("aft_losses", reduction="avg")
        summary_windows = [counts, aft_losses]

    stop_requested = {}

    def _on_term(signum, frame):
        stop_requested["sig"] = signum
    previous_handler = signal.signal(signal.SIGTERM, _on_term)

    def agree_stop() -> bool:
        """Whether any rank was asked to stop (an all-reduce of the flag,
        so that every rank stops and saves at the same step)."""
        flag = torch.tensor([int(bool(stop_requested))], device=device)
        torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    log_interval = args.log_interval or 50
    pending = []
    last_host_losses = None
    window_tic = time.time()

    def flush_pending():
        """One device->host transfer for the queued steps' losses; the
        window time is shared out as in the JAX package (a step whose
        dispatch blocked keeps its excess on its own line).  Every rank
        takes part: at world > 1 rank 0 gathers each rank's per-sample
        losses and languages for the per-language windows, and logs."""
        nonlocal last_host_losses
        if not pending:
            return
        scalars = torch.stack([
            torch.stack([e["losses"][k].float() for k in _SCALAR_KEYS])
            for e in pending]).cpu().numpy()
        samples = None
        if hp.multi_lingual:
            samples = [[(e["langs"], e["losses"]["aft_losses"].cpu().numpy())]
                       for e in pending]
            if world > 1:
                gathered = [None] * world if rank == 0 else None
                torch.distributed.gather_object(samples, gathered, dst=0)
                if rank == 0:
                    samples = [sum((g[i] for g in gathered), [])
                               for i in range(len(pending))]
        if rank != 0:
            pending.clear()
            return
        total = time.time() - window_tic
        extras = [max(0.0, e["dispatch_s"] - 1.0) for e in pending]
        base = max(0.0, total - sum(extras)) / len(pending)
        for i, (e, row, extra) in enumerate(zip(pending, scalars, extras)):
            hl = dict(zip(_SCALAR_KEYS, (float(x) for x in row)))
            hl["lr"] = e["losses"]["lr"]
            dur = base + extra
            time_window.append(dur)
            loss_window.append(hl["mse_loss"])
            audio_s = e["frames"] * hp.frame_shift_ms / 1000.0
            logging.info(
                "[Step %d] %.3f sec/step (%.3f), lr=%.06f, loss=%.5f, "
                "mse_loss=%.5f (Ave. %.5f), %.1f audio_s/s", e["step"], dur,
                time_window.average, hl["lr"], hl["loss"], hl["mse_loss"],
                loss_window.average, audio_s / max(dur, 1e-9))
            if hp.multi_lingual:
                for langs, per_sample in samples[i]:
                    counts.update(langs, [1] * len(langs))
                    aft_losses.update(langs, list(per_sample[:len(langs)]))
            last_host_losses = hl
        pending.clear()

    # torch.save and the disk run on a writer thread; only the copy of the
    # state to the host runs on the step's thread
    saver = ckpt_lib.AsyncCheckpointer()

    logging.info("Start training run")
    batch = feeder.get_batch()
    dbatch = device_batch(batch, hp, device)
    if world > 1:
        logging.info("Global batch shape (rows, T_in, T_out) of the first "
                     "step: %s", mesh_lib.agree_global_shape(batch, device))
    window_tic = time.time()
    try:
        while args.max_steps is None or global_step < args.max_steps:
            try:
                tic = time.perf_counter()
                losses = train_step(
                    step_model, optimizer, scheduler, dbatch, hp,
                    step_generator(args.seed, global_step, device, rank),
                    group)
                dispatch_s = time.perf_counter() - tic
                # the next batch is prepared while the card computes
                next_batch = feeder.get_batch()
                next_dbatch = device_batch(next_batch, hp, device)
            except Exception:
                logging.error("Failed, input shape: %s, target shape: %s",
                              str(batch["inputs"].shape),
                              str(batch["mel_targets"].shape))
                saver.wait()
                crash_save(logdir, model_dir, rank, feeder, model,
                           optimizer, scheduler, global_step)
                raise

            global_step += 1
            feeder.global_step = global_step
            entry = {"step": global_step, "losses": losses,
                     "dispatch_s": dispatch_s,
                     "frames": int(np.sum(batch["target_lengths"]))}
            if hp.multi_lingual:
                lang_ids = [language_vec_to_id(lv)
                            for lv in batch["input_language_vecs"]]
                entry["langs"] = [id_to_lang[i] for i in lang_ids if i >= 0]
            pending.append(entry)
            batch, dbatch = next_batch, next_dbatch

            # the steps every rank stops at together; at world > 1 a stop
            # request waits for the next one, where the ranks agree on it
            common = (global_step % log_interval == 0 or
                      global_step % args.summary_interval == 0 or
                      global_step % args.checkpoint_interval == 0 or
                      (eval_steps and global_step in eval_steps) or
                      (args.max_steps is not None and
                       global_step >= args.max_steps))
            if world == 1:
                stop = bool(stop_requested)
            else:
                stop = bool(common) and agree_stop()
            boundary = common or stop
            if boundary:
                flush_pending()

            if global_step % args.checkpoint_interval == 0 or stop:
                saver.save(model_dir, model, optimizer, scheduler,
                           global_step, sharded=world > 1, rank=rank,
                           world=world)
                ckpt_lib.save_feeder_state(logdir, rank, feeder)
                if rank == 0:
                    logging.info("Save checkpoint to %s", model_dir)
                    # once the file has landed, so no half-written file is
                    # copied
                    saver.then(_mirror_logs, logdir,
                               os.path.join(model_dir, "logs"))

            if global_step % args.summary_interval == 0 and writer:
                for key in ["loss", "mse_loss", "l2", "stop_loss",
                            "aft_loss"]:
                    writer.add_scalar("losses/" + key, last_host_losses[key],
                                      global_step)
                writer.add_scalar("lr", last_host_losses["lr"], global_step)
                for window in summary_windows:
                    for k, v in window.summary():
                        writer.add_scalar(k, v, global_step)
                    window.clear()

            run_inline_eval = (
                (eval_steps and global_step in eval_steps) or
                (eval_steps is None and
                 global_step % args.checkpoint_interval == 0))
            if run_inline_eval and feeder_eval is not None:
                # the unwrapped module: no rank enters a DDP collective alone
                _inline_eval(model, hp, feeder_eval, logdir, global_step)
            if boundary:
                # boundary work (saves, eval) stays out of the step windows
                window_tic = time.time()
            if stop:
                logging.info("Termination signal received; state saved, "
                             "exiting.")
                break
        flush_pending()
    finally:
        saver.wait()
        signal.signal(signal.SIGTERM, previous_handler)
        if writer:
            writer.close()
    return model, global_step


def default_backend(device) -> str:
    """The process group's backend unless ``--dist_backend`` names one:
    NCCL for a card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def crash_save(logdir, model_dir, rank, feeder, model, optimizer, scheduler,
               global_step):
    """Persist feeder and model state from the train loop's failure path
    (reference train.py:175-186, JAX ``crash_save``): every rank its feeder
    state, rank 0 the single-file checkpoint of the replicated state, with
    no collective.  Each save is best effort and logs its own failure, so
    the original error still surfaces."""
    try:
        ckpt_lib.save_feeder_state(logdir, rank, feeder)
    except Exception:
        logging.error("Feeder state save failed:\n%s", traceback.format_exc())
    if rank != 0:
        return
    try:
        ckpt_lib.save_state(model_dir, model, optimizer, scheduler,
                            global_step)
        logging.info("Crash checkpoint saved at step %d", global_step)
    except Exception:
        logging.error("Crash checkpoint failed:\n%s", traceback.format_exc())


def _mirror_logs(logdir, dest):
    """Mirror the log dir next to the checkpoints (reference train.py:213
    uses ``rsync -avu``); best effort, skipped without rsync."""
    try:
        if shutil.which("rsync"):
            subprocess.run(["rsync", "-au", logdir + "/", dest + "/"],
                           check=False, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        logging.warning("Mirroring %s to %s failed:\n%s", logdir, dest,
                        traceback.format_exc())


def _inline_eval(model, hp, feeder_eval, logdir, global_step):
    """Inline synthesis eval (reference train.py:225-249): decoder dropout
    on; a failing batch is logged and skipped."""
    from ..infer import save_eval_results, synthesize_batch
    eval_path = os.path.join(logdir, "eval_%d" % global_step)
    os.makedirs(eval_path, exist_ok=True)
    batches = feeder_eval.fetch_data()
    logging.info("Running %d evals, to %s", len(batches), eval_path)
    model.eval()
    try:
        for batch in batches[:hp.max_eval_batches]:
            try:
                tic = time.time()
                results = synthesize_batch(model, batch, hp,
                                           deterministic=False)
                save_eval_results(**results, output_dir=eval_path, hp=hp,
                                  save_trimmed_wave=False)
                logging.info("Finished batch in %.2f sec, samples: %s",
                             time.time() - tic, batch["names"])
            except Exception:
                logging.error("Eval batch failed:\n%s",
                              traceback.format_exc())
    finally:
        model.train()
