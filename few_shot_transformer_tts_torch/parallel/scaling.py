"""Data-parallel scaling benchmark of the port (counterpart of
``few_shot_transformer_tts_tpu/parallel/scaling.py``).

Measures the DDP train step (``train/loop.py:train_step`` under
``DistributedDataParallel``, with the loss and BatchNorm all-reduces, as
the train CLI builds it: ``make_grid`` and ``parallel_step_model``) at
each data-parallel degree N: N processes, one per GPU, started with
``torch.multiprocessing``.  Two modes, as in the JAX module:

  * weak (default): the global batch grows with N (``per_device_batch``
    rows per rank); efficiency is the per-device audio rate over the
    1-device run's.
  * strong: the global batch is fixed at ``per_device_batch * max(degrees)``
    and split over the N ranks; efficiency is sec_per_step(1) /
    sec_per_step(N).

Each line reports the median sec/step of ``--steps`` steps after one
warm-up step (host clock to ``torch.cuda.synchronize()``), audio s/s, per
device and in all, and the efficiency.  A degree above the host's card
count can only run over gloo with ranks sharing cards: its line says
``"shared_cards": true`` and is not multi-GPU scaling (on one H100 only
degree 1 is real).

Run: python -m few_shot_transformer_tts_torch.parallel.scaling --devices 1
     [--mode strong] [--dist_backend gloo] [--device cpu --small]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch


def example_batch(hp, b: int, t_in: int, t_out: int, seed: int = 0) -> dict:
    """A synthetic padded batch from a numpy seed; row 0 has the full
    lengths."""
    rng = np.random.RandomState(seed)
    il = rng.randint(t_in // 2, t_in + 1, b).astype(np.int32)
    tl = rng.randint(t_out // 2, t_out + 1, b).astype(np.int32)
    il[0], tl[0] = t_in, t_out
    mel = np.clip(rng.randn(b, t_out, hp.num_mels), -4, 4).astype(np.float32)
    mel[np.arange(t_out)[None, :] >= tl[:, None]] = 0.0
    return dict(
        inputs=rng.randint(3, 255, (b, t_in)).astype(np.int32),
        input_lengths=il, mel_targets=mel, target_lengths=tl,
        input_spk_ids=rng.randint(0, hp.max_num_speaker, b).astype(np.int32),
        input_language_vecs=np.eye(hp.max_num_language, dtype=np.float32)[
            rng.randint(0, hp.max_num_language, b)])


def _rank(rank, world, port, hp, rows, t_in, t_out, steps, device, backend,
          out_path):
    """One rank of one degree: its ``rows`` of the global batch under DDP;
    rank 0 writes (sec/step, frames of the global batch) to ``out_path``."""
    from ..models.tacotron import ByteToMel, init_weights_
    from ..train.loop import (device_batch, make_optimizer,
                              parallel_step_model, step_generator,
                              train_step)
    from . import mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dev = mesh.init_distributed(backend, device)
    try:
        model = init_weights_(ByteToMel(hp, device=dev), 0)
        optimizer, scheduler = make_optimizer(model, hp)
        grid = mesh.make_grid(1)
        step_model = parallel_step_model(model, grid, dev)
        full = example_batch(hp, rows * world, t_in, t_out)
        local = {k: v[rank::world] for k, v in full.items()}
        batch = device_batch(local, hp, dev)

        def step(i):
            out = train_step(step_model, optimizer, scheduler, batch, hp,
                             step_generator(0, i, dev, rank),
                             grid.stats_group)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out

        step(0)                       # warm-up: allocation, kernel builds
        times = []
        for i in range(steps):
            tic = time.perf_counter()
            out = step(i + 1)
            times.append(time.perf_counter() - tic)
        if not np.isfinite(float(out["loss"])):
            raise RuntimeError("non-finite loss at degree %d" % world)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump((float(np.median(times)),
                             int(full["target_lengths"].sum())), f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def measure(hp, per_device_batch: int, t_in: int, t_out: int, degrees,
            steps: int = 10, mode: str = "weak", device: str = "cuda",
            backend: str = "nccl") -> list:
    """One result dict per degree (the JAX module's fields, plus
    ``shared_cards``)."""
    if mode not in ("weak", "strong"):
        raise ValueError("mode must be weak or strong, got %r" % mode)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    results = []
    for n in degrees:
        b = per_device_batch * (max(degrees) if mode == "strong" else n)
        if b % n:
            raise ValueError("a global batch of %d rows does not split over "
                             "%d ranks" % (b, n))
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "result.pkl")
            torch.multiprocessing.start_processes(
                _rank, args=(n, _free_port(), hp, b // n, t_in, t_out,
                             steps, device, backend, out_path),
                nprocs=n, start_method="spawn")
            with open(out_path, "rb") as f:
                sec, frames = pickle.load(f)
        audio_s = frames * hp.frame_shift_ms / 1000.0
        results.append({"devices": n, "mode": mode, "batch": b,
                        "sec_per_step": sec,
                        "audio_s_per_sec": audio_s / sec,
                        "audio_s_per_sec_per_device": audio_s / sec / n,
                        "device": device, "backend": backend,
                        "shared_cards": device == "cuda" and n > cards})
    for r in results:
        if mode == "strong":
            r["efficiency"] = results[0]["sec_per_step"] / r["sec_per_step"]
        else:
            r["efficiency"] = (r["audio_s_per_sec_per_device"] /
                               results[0]["audio_s_per_sec_per_device"])
    return results


def main(argv=None):
    from ..config import default_config, small_test_config
    parser = argparse.ArgumentParser()
    parser.add_argument("--devices", default=None,
                        help="comma list of DP degrees (default 1..all cards)")
    parser.add_argument("--per_device_batch", type=int, default=2)
    parser.add_argument("--t_in", type=int, default=64)
    parser.add_argument("--t_out", type=int, default=128)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--mode", choices=("weak", "strong"), default="weak")
    parser.add_argument("--small", action="store_true",
                        help="use a small model config (CPU-friendly)")
    parser.add_argument("--device", default="cuda",
                        help='"cuda" (default; raises without a card) or '
                             '"cpu"')
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"),
                        default=None,
                        help="default nccl on a card, gloo on the CPU")
    args = parser.parse_args(argv)
    from ..utils.device import resolve_device
    resolve_device(args.device)
    on_card = args.device == "cuda"
    hp = small_test_config() if args.small else default_config(
        use_bfloat16=on_card)
    backend = args.dist_backend or ("nccl" if on_card else "gloo")
    if args.devices:
        degrees = [int(d) for d in args.devices.split(",")]
    else:
        n = torch.cuda.device_count() if on_card else 1
        degrees = [d for d in [1, 2, 4, 8, 16, 32] if d <= n]
    results = measure(hp, args.per_device_batch, args.t_in, args.t_out,
                      degrees, steps=args.steps, mode=args.mode,
                      device=args.device, backend=backend)
    for r in results:
        print(json.dumps(r))
    if any(r["shared_cards"] for r in results):
        print("degrees above %d share cards over gloo: not multi-GPU "
              "scaling" % torch.cuda.device_count())
    return results


if __name__ == "__main__":
    main()
