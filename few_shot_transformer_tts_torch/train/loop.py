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
SIGTERM.  A rolling host mirror of the state (``--mirror_interval``, and
every checkpoint's own host copy) is what ``crash_save`` writes when the
live state cannot be fetched, and ``--profile_dir`` traces a window of
steps with ``torch.profiler`` (``Profiler``).

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
the ranks (``compute_loss`` and ``MaskedBatchNorm`` with the grid's
``stats_group``), and every checkpoint is the sharded
``model.ckpt-<step>.d`` (each rank its own leaves and ``feeder_<rank>.pkl``).
Rank 0 alone writes the logs, the metrics and the inline eval.  With
``hp.mesh_model_axis`` M > 1 the ranks form the ``(data, model)`` grid of
``parallel.mesh.make_grid`` and, as the JAX CLI does, run the replicated
step on it: the Feeder, DDP, the losses and the BatchNorm statistics go
over the data index, so the M ranks of a model group train on the same
rows.  The tensor-parallel step (``parallel/sharding_rules.py``) is a
library call, as the JAX package's ``state_sharding`` is: split the model
with ``shard_model_`` before ``make_optimizer`` and step it through
``parallel_step_model``.
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
from ..utils import infolog, tracing
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
    with tracing.span("data.device_batch"):
        host = {k: batch[k] for k in _BATCH_KEYS if k in batch}
        if hp.wire_mel_int16:
            with tracing.span("data.quantize"):
                host = quantize_wire_mels(host, hp)
        with tracing.span("data.h2d"):
            out = {k: torch.from_numpy(np.asarray(v)).to(device)
                   for k, v in host.items()}
        with tracing.span("data.dequantize"):
            return dequantize_wire_mels(out, hp)


def step_generator(seed: int, step: int, device, rank: int = 0
                   ) -> torch.Generator:
    """The dropout generator of one step on ``device``: a pure function of
    (seed, step), with ``rank`` folded in when it is not 0, so that
    data-parallel ranks draw different masks (torch dropout and the
    attention kernels' Philox seeds both come from it).  ``rank`` is the
    data index (``Grid.data_rank``): the ranks of one model group draw the
    same masks."""
    entropy = [seed, step] if rank == 0 else [seed, step, rank]
    hi, lo = np.random.SeedSequence(entropy).generate_state(2)
    gen = torch.Generator(device)
    gen.manual_seed(((int(hi) << 32) | int(lo)) & (2 ** 63 - 1))
    return gen


class StateUpdateError(RuntimeError):
    """The optimizer step failed part way: the parameters and moments may
    be half-updated, so ``crash_save`` does not save them."""


def parallel_step_model(model: ByteToMel, grid: mesh_lib.Grid, device):
    """The step's module: ``model`` under DDP over ``grid``'s data group
    when that spans ranks (its hooks average the gradients), else
    ``model``.  Call it after ``shard_model_`` and ``make_optimizer``."""
    if grid.data_group is None:
        return model
    device = torch.device(device)
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, process_group=grid.data_group)


def train_step(model: ByteToMel, optimizer, scheduler,
               batch: Dict[str, torch.Tensor], hp: Config,
               generator: torch.Generator, group=None) -> Dict:
    """One step: forward (train mode), loss, backward, Adam, schedule.
    Returns the losses as device tensors (no host sync) and ``lr``, the LR
    this step applied.  ``model`` may be the DDP-wrapped model; ``group``
    (data parallel at world > 1) makes the losses and BatchNorm statistics
    those of every rank's rows (``compute_loss``).  An exception inside the
    optimizer step surfaces as ``StateUpdateError``.  Spans: ``train.step``,
    holding ``train.forward``, ``train.loss``, ``train.backward``
    and ``train.optimizer`` (zero_grad; Adam and the schedule)."""
    with tracing.span("train.step"):
        model.train()
        with tracing.span("train.forward"):
            outputs = model(batch["inputs"], batch["input_lengths"],
                            batch["mel_targets"], batch["target_lengths"],
                            batch.get("input_spk_ids"),
                            batch.get("input_language_vecs"), train=True,
                            generator=generator, group=group)
        with tracing.span("train.loss"):
            losses = compute_loss(model, batch["mel_targets"],
                                  batch["target_lengths"], outputs, hp, group)
        with tracing.span("train.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with tracing.span("train.backward"):
            losses.pop("objective", losses["loss"]).backward()
        with tracing.span("train.optimizer"):
            lr = optimizer.param_groups[0]["lr"]
            try:
                optimizer.step()
            except Exception as e:
                raise StateUpdateError("the optimizer step failed; the "
                                       "parameters may be half-updated") \
                    from e
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
    grid = mesh_lib.make_grid(hp.mesh_model_axis)
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

    # sharded over the data index: the ranks of a model group see one
    # stream of rows
    feeder = Feeder(
        zipfilepath, train_meta, hparams=hp, spk_to_id=spk_to_id,
        lang_to_id=lang_to_id, rank=grid.data_rank, world_size=grid.data,
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

    # the step's module: DDP over the data group when it spans ranks;
    # checkpoints and eval take the model
    step_model = parallel_step_model(model, grid, device)
    group = grid.stats_group

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
            if grid.model_rank:   # its rows are model rank 0's as well
                samples = [[] for _ in pending]
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
    # the rolling host mirror that crash_save falls back to when the live
    # state cannot be fetched: this rank's checkpoint snapshot, taken here,
    # every mirror_interval steps and at each checkpoint
    mirror_interval = getattr(args, "mirror_interval", None) or 1000
    snapshot = lambda step: ckpt_lib.snapshot(
        model, optimizer, scheduler, step, world > 1, rank, world, grid)
    host_mirror = snapshot(global_step)
    profiler = Profiler(args, rank, device)
    host_spans = None       # the tracing window at the last summary

    logging.info("Start training run")
    batch = feeder.get_batch()
    dbatch = device_batch(batch, hp, device)
    if world > 1:
        logging.info("Global batch shape (rows, T_in, T_out) of the first "
                     "step: %s", mesh_lib.agree_global_shape(batch, device))
    window_tic = time.time()
    try:
        while args.max_steps is None or global_step < args.max_steps:
            profiler.before_step(global_step)
            try:
                losses = train_step(
                    step_model, optimizer, scheduler, dbatch, hp,
                    step_generator(args.seed, global_step, device,
                                   grid.data_rank), group)
                dispatch_s = tracing.last_seconds()    # train.step's
                # the next batch is prepared while the card computes
                next_batch = feeder.get_batch()
                next_dbatch = device_batch(next_batch, hp, device)
            except Exception as e:
                logging.error("Failed, input shape: %s, target shape: %s",
                              str(batch["inputs"].shape),
                              str(batch["mel_targets"].shape))
                saver.wait()
                crash_save(logdir, model_dir, rank, feeder, model,
                           optimizer, scheduler, global_step, world=world,
                           grid=grid, mirror=host_mirror,
                           live_ok=not isinstance(e, StateUpdateError))
                raise

            global_step += 1
            feeder.global_step = global_step
            profiler.after_step(global_step)
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
                host_mirror = saver.save(model_dir, model, optimizer,
                                         scheduler, global_step,
                                         sharded=world > 1, rank=rank,
                                         world=world, grid=grid)
                ckpt_lib.save_feeder_state(logdir, rank, feeder)
                if rank == 0:
                    logging.info("Save checkpoint to %s", model_dir)
                    # once the file has landed, so no half-written file is
                    # copied
                    saver.then(_mirror_logs, logdir,
                               os.path.join(model_dir, "logs"))
            elif global_step % mirror_interval == 0:
                host_mirror = snapshot(global_step)

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
                host_spans = write_host_ms(writer, host_spans, global_step)

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
        profiler.stop()
        saver.wait()
        signal.signal(signal.SIGTERM, previous_handler)
        if writer:
            writer.close()
    return model, global_step


def write_host_ms(writer, last, global_step):
    """Write the host ms a step of each span since the summary that read
    ``last`` (the whole window when it was another) as
    ``host/<span>_ms``; returns the window read, for the next summary."""
    now = tracing.windows()[-1]
    if last is None or last["index"] != now["index"]:
        last = {"spans": {}}
    before = lambda name: last["spans"].get(name, (0, 0.0, 0.0))
    steps = now["spans"].get("train.step", (0,))[0] - before("train.step")[0]
    if steps > 0:
        for name, (_, total, _) in sorted(now["spans"].items()):
            writer.add_scalar("host/%s_ms" % name,
                              1e3 * (total - before(name)[1]) / steps,
                              global_step)
    return now


def default_backend(device) -> str:
    """The process group's backend unless ``--dist_backend`` names one:
    NCCL for a card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def crash_save(logdir, model_dir, rank, feeder, model, optimizer, scheduler,
               global_step, world=1, grid=None, mirror=None, live_ok=True):
    """Persist feeder and model state from the train loop's failure path
    (reference train.py:175-186, JAX ``crash_save``), with no collective:
    first every rank its feeder state; then the live state, at world 1 rank
    0's ``model.ckpt-<step>``, at world > 1 each rank its shard file of
    ``model.ckpt-<step>.d``; and only when the live state cannot be
    fetched (a copy to the host raises, as every one does after a sticky
    CUDA error) or ``live_ok`` is False (the optimizer step failed part
    way), the host ``mirror`` (a ``checkpoint.Snapshot``) at its own step.
    Each save is best effort and logs its own failure, so the original
    error still surfaces.  At world > 1 a directory is whole only when
    every rank took the same branch; ``checkpoint.find_ckpt`` skips one
    that is not, so a resume starts from the last whole checkpoint."""
    try:
        ckpt_lib.save_feeder_state(logdir, rank, feeder)
    except Exception:
        logging.error("Feeder state save failed:\n%s", traceback.format_exc())
    if rank != 0 and world == 1:
        return
    snap = None
    if live_ok:
        try:
            snap = ckpt_lib.snapshot(model, optimizer, scheduler,
                                     global_step, world > 1, rank, world,
                                     grid)
        except Exception:
            logging.error("Live state unavailable after the failed step; "
                          "falling back to the host mirror:\n%s",
                          traceback.format_exc())
    else:
        logging.error("The failed optimizer step may have left the live "
                      "state half-updated; falling back to the host mirror")
    source = "the live state"
    if snap is None:
        snap, source = mirror, "the host mirror"
        if snap is None:
            logging.error("No host mirror to save")
            return
    try:
        snap.write(model_dir)
        logging.info("Crash checkpoint saved from %s at step %d", source,
                     snap.step)
    except Exception:
        logging.error("Crash checkpoint failed:\n%s", traceback.format_exc())


class Profiler:
    """The ``--profile_dir`` trace: ``torch.profiler`` (CPU, and CUDA on a
    card) over the steps ``[profile_step, profile_step + profile_n_steps)``,
    ended at a ``torch.cuda.synchronize`` so that the last step's kernels
    are in it, then written as a Chrome trace,
    ``<profile_dir>/trace_rank<rank>_steps<first>-<last>.json``, and its path
    logged with the traced steps' device busy share and the longest idle
    gaps by program span (``utils/tracing.py``: each step is its
    ``train.step`` range, with the step's spans inside it).  Outside the
    window a step pays a few integer compares: no profiler object
    exists."""

    def __init__(self, args, rank: int, device):
        self.dir = getattr(args, "profile_dir", None)
        self.first = getattr(args, "profile_step", 50)
        self.end = self.first + getattr(args, "profile_n_steps", 5)
        self.rank = rank
        self.device = torch.device(device)
        self._prof = None

    def before_step(self, step: int) -> None:
        """Start the trace before step ``profile_step`` (0-based)."""
        if self.dir and step == self.first and self.end > self.first:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def after_step(self, steps_done: int) -> None:
        if self._prof is not None and steps_done >= self.end:
            self.stop()

    def stop(self) -> None:
        """End the trace (at the window's end, or where the run ends) and
        write it; a no-op when none runs."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace_rank%d_steps%d-%d.json" % (
            self.rank, self.first, self.end - 1))
        prof.export_chrome_trace(path)
        logging.info("Profiler trace written to %s", path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        busy = tracing.busy_share(events)
        gaps = tracing.idle_gaps(events, top=3)
        logging.info("Traced steps: device busy %s; longest idle gaps: %s",
                     "n/a" if busy is None else "%.1f%%" % (100 * busy),
                     ", ".join("%.2f ms in %s" % (1e3 * s, name)
                               for name, s, _ in gaps) or "none")


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
