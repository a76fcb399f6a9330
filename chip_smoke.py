#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (few_shot_transformer_tts_torch).

    python3 chip_smoke.py [--seed 0] [--out-dir build/chip_smoke]

Needs one CUDA card, nvcc and the repository checkout; imports nothing of
JAX.  Phases, each printed as one JSON line on stdout (any failure is an
uncaught exception and a non-zero exit):

  1. device: the card's name and power limit (nvidia-smi).
  2. build: nvcc builds csrc/mha_fwd.cu for sm_90a; seconds and the
     ptxas resource summary.
  3. kernel_check: the CUDA attention kernel against its plain PyTorch
     version on the card, bf16, at the three flagship call shapes (encoder
     self-attention, decoder causal, cross-attention) and edge shapes
     (Tk = 2048, Tq = 600, Tk not a multiple of the 32-key tile), plus one
     fp32 case.  Max abs error of o and lse against the stated tolerances;
     kernel, plain and scaled_dot_product_attention times (CUDA events,
     warm L2 as on the main path, where the projection has just written
     q/k/v) beside the byte/FLOP bound.
  4. main_path: the flagship default_config() (6+6 layers, 512/768, 8 heads,
     80 mels) with weights from --seed through numpy, stop bias -1e4 so every
     row decodes to the cap; synthesize_batch at B=8, T_in=192, 512 frames,
     deterministic.  The kernel must launch exactly 6 times (one per encoder
     layer); the encoder output and the first 32 frames must match the plain
     attention path on the card; frames/s, RTF, encoder ms.  The
     teacher-forced forward (18 launches: encoder, decoder causal and
     cross-attention) must match the plain path too.  Then the same
     call once with decoder dropout on, and a torch.profiler window of 64
     frames (device busy time against wall time, launches per frame).
  5. cli: a reference-format checkpoint of the random weights, a 2-line
     script and the id maps through ``python -m
     few_shot_transformer_tts_torch.synthesize`` (in-process, 64 frames);
     the .npy and .wav files must exist.

Then a {"kernels": [...]} line, and last {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from few_shot_transformer_tts_torch.config import default_config
from few_shot_transformer_tts_torch.infer import synthesize_batch
from few_shot_transformer_tts_torch.infer.synthesize import (
    matmul_weights_in, prepare_decode_inputs)
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.ops import cuda_build
from few_shot_transformer_tts_torch.ops.mha import (mha_forward,
                                                    mha_forward_plain)
from few_shot_transformer_tts_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# dense tensor-core bf16; fp32 outside the tensor cores (TF32 is off)
PEAK_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# bf16 kernel vs plain: both round o to bf16 (1 ulp = 0.0156 at |o| in
# [2, 4)) and p to bf16 at different running maxima; lse is fp32 with
# different summation orders.
TOL_BF16 = {"o": 3e-2, "lse": 1e-3}
TOL_FP32 = {"o": 1e-4, "lse": 1e-4}
# main path, kernel vs plain attention on the card, bf16 end to end: the
# per-call differences above pass through 6 encoder layers (and the AR
# feedback of 32 frames) before these outputs.
TOL_ENCODER = 0.125
TOL_FRAMES = 0.25
# teacher-forced mel_bef, kernel vs plain: 6 encoder and 6 decoder layers
TOL_TEACHER = 0.25


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn over iters launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def attention_inputs(rng, b, tq, tk, c, cross, lengths, dtype):
    """q/k/v as the model hands them over: split views of the fused QKV
    (self-attention) or Q plus split views of the fused KV (cross)."""
    dev = "cuda"
    if not cross:
        fused = torch.from_numpy(rng.randn(b, tq, 3 * c).astype(np.float32))
        q, k, v = fused.to(dev, dtype).split([c, c, c], -1)
    else:
        q = torch.from_numpy(rng.randn(b, tq, c).astype(np.float32)).to(
            dev, dtype)
        fused = torch.from_numpy(rng.randn(b, tk, 2 * c).astype(np.float32))
        k, v = fused.to(dev, dtype).split([c, c], -1)
    bias = None
    if lengths is not None:
        bias = torch.from_numpy(np.where(
            np.arange(tk)[None, :] < np.asarray(lengths)[:, None], 0.0,
            -1e20).astype(np.float32)).to(dev)
    return q, k, v, bias


def attention_bound(b, tq, tk, c, heads, causal, use_bias, dtype):
    """Least time for the function: inputs read once, outputs written
    once, against the card's peak rate for the input type, for the
    products that this mask needs (causal: key <= query only)."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (b * tq * c + 2 * b * tk * c) * elt + b * tq * c * elt + \
        b * tq * heads * 4 + (b * tk * 4 if use_bias else 0)
    pairs = b * tq * (tq + 1) // 2 if causal else b * tq * tk
    flops = 4.0 * pairs * c                    # QK^T and PV over all heads
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations"), nbytes, flops


def check_kernel(name, rng, b, tq, tk, c, heads, causal, lengths,
                 cross=False, dtype=torch.bfloat16, iters=50):
    q, k, v, bias = attention_inputs(rng, b, tq, tk, c, cross, lengths,
                                     dtype)
    use_bias = bias is not None
    scale = (c // heads) ** -0.5
    args = (q, k, v, bias, heads, causal, scale, use_bias)
    o, lse = mha_forward(*args)
    o_ref, lse_ref = mha_forward_plain(*args)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_FP32
    ok = err_o <= tol["o"] and err_lse <= tol["lse"] and \
        bool(torch.isfinite(o).all())

    ms = cuda_ms(lambda: mha_forward(*args), iters)
    plain_ms = cuda_ms(lambda: mha_forward_plain(*args), max(iters // 5, 3))
    d = c // heads
    qh = q.view(b, tq, heads, d).transpose(1, 2)
    kh = k.view(b, tk, heads, d).transpose(1, 2)
    vh = v.view(b, tk, heads, d).transpose(1, 2)
    mask = bias[:, None, None, :].to(dtype) if use_bias else None
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, is_causal=causal, scale=scale), iters)
    bound_ms, bound_by, nbytes, flops = attention_bound(
        b, tq, tk, c, heads, causal, use_bias, dtype)
    row = {"phase": "kernel_check", "case": name, "dtype": str(dtype),
           "B": b, "Tq": tq, "Tk": tk, "C": c, "H": heads,
           "causal": causal, "bias": use_bias,
           "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
           "tol_o": tol["o"], "tol_lse": tol["lse"], "ok": ok,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops}
    emit(row)
    if not ok:
        raise AssertionError("mha_forward disagrees with its plain version "
                             "at %s: %s" % (name, row))
    return row


def kernel_phase(seed):
    rng = np.random.RandomState(seed)
    rows = {}
    # flagship call shapes: encoder self-attention, decoder causal, cross
    enc_len = rng.randint(96, 193, 8)
    rows["encoder"] = check_kernel("encoder", rng, 8, 192, 192, 512, 8,
                                   False, enc_len)
    check_kernel("decoder_causal", rng, 8, 448, 448, 768, 8, True, None)
    check_kernel("cross", rng, 8, 448, 192, 768, 8, False, enc_len,
                 cross=True)
    # edges: the 2048-key dispatch limit, a 600-row causal call, a key
    # count that is not a multiple of the tile, and the fp32 instantiation
    check_kernel("tk2048", rng, 2, 2048, 2048, 512, 8, False, [2048, 1500],
                 iters=10)
    check_kernel("tq600_causal", rng, 2, 600, 600, 768, 8, True, None)
    check_kernel("tk77_cross", rng, 3, 45, 77, 768, 8, False, [77, 50, 1],
                 cross=True)
    check_kernel("encoder_fp32", rng, 8, 192, 192, 512, 8, False, enc_len,
                 dtype=torch.float32)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def flagship_batch(hp, seed, b=8, t_in=192):
    rng = np.random.RandomState(seed)
    return dict(
        inputs=rng.randint(3, 255, (b, t_in)).astype(np.int32),
        input_lengths=rng.randint(t_in // 2, t_in + 1, b).astype(np.int32),
        input_spk_ids=rng.randint(0, hp.max_num_speaker, b).astype(np.int32),
        input_language_vecs=np.eye(hp.max_num_language, dtype=np.float32)[
            rng.randint(0, 38, b)],
        names=["utt%d" % i for i in range(b)])


def flagship_model(hp, seed, device):
    model = init_weights_(ByteToMel(hp, device=device), seed)
    with torch.no_grad():
        model.decoder.stop_net.bias.fill_(-1e4)  # every row runs to the cap
    return model.eval()


@torch.no_grad()
def encode(model, hp, batch):
    inputs, lengths, spk, lvec = (torch.from_numpy(a).cuda() for a in
                                  prepare_decode_inputs(batch, hp))
    with matmul_weights_in(model, model.dtype):
        return model.encode(inputs, lengths, spk, lvec)[0]


@torch.no_grad()
def teacher_forced_check(model, plain, hp, batch, seed, t_out=448):
    """The eval-mode teacher-forced forward, whose decoder reaches the
    kernel causal (D=96) and as cross-attention (Tq != Tk): launches and
    mel_bef against the plain attention path."""
    rng = np.random.RandomState(seed + 1)
    b = len(batch["inputs"])
    args = [torch.from_numpy(a).cuda() for a in (
        batch["inputs"], batch["input_lengths"],
        rng.randn(b, t_out, hp.num_mels).astype(np.float32),
        rng.randint(t_out // 2, t_out + 1, b).astype(np.int32),
        batch["input_spk_ids"], batch["input_language_vecs"])]
    before = mha_forward.launches
    out = model(*args)["mel_bef"]
    launches = mha_forward.launches - before
    err = (out - plain(*args)["mel_bef"]).abs().max().item()
    return launches, err


def main_path_phase(seed):
    hp = default_config()
    model = flagship_model(hp, seed, "cuda")
    plain = ByteToMel(hp.replace(use_pallas_attention=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain.eval()
    batch = flagship_batch(hp, seed)
    frames = 512

    # warm-up (cuBLAS/cuDNN handles, allocator), not counted
    synthesize_batch(model, batch, hp, deterministic=True,
                     collect_alignments=False, max_frames=8)
    torch.cuda.synchronize()

    mha_forward.launches = 0
    tic = time.perf_counter()
    out = synthesize_batch(model, batch, hp, deterministic=True,
                           collect_alignments=False, max_frames=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = mha_forward.launches
    if launches != hp.n_encoder_layer:
        raise AssertionError("main path launched the kernel %d times, "
                             "expected %d" % (launches, hp.n_encoder_layer))
    mel = out["mel_aft"]
    if mel.shape != (8, frames, hp.num_mels) or \
            not np.isfinite(mel).all() or \
            not np.isfinite(out["mel_pre"]).all():
        raise AssertionError("bad synthesis output: shape %s, finite %s"
                             % (mel.shape, np.isfinite(mel).all()))
    n_frames = int(np.sum(out["generated_lengths"]))

    # the same encoder and first frames through the plain attention path
    enc_k = encode(model, hp, batch)
    enc_p = encode(plain, hp, batch)
    enc_err = (enc_k.float() - enc_p.float()).abs().max().item()
    out_p = synthesize_batch(plain, batch, hp, deterministic=True,
                             collect_alignments=False, max_frames=32)
    frame_err = float(np.abs(out["mel_pre"][:, :32] -
                             out_p["mel_pre"]).max())
    enc_ms = cuda_ms(lambda: encode(model, hp, batch), 10)
    tf_launches, tf_err = teacher_forced_check(model, plain, hp, batch, seed)

    row = {"phase": "main_path", "config": "default_config (flagship)",
           "B": 8, "T_in": 192, "max_frames": frames,
           "kernel_launches": launches, "wall_s": wall,
           "frames": n_frames, "frames_per_s": n_frames / wall,
           "rtf": wall / n_frames * 80, "encoder_ms": enc_ms,
           "encoder_max_abs_err_vs_plain": enc_err, "tol_encoder": TOL_ENCODER,
           "first32_max_abs_err_vs_plain": frame_err, "tol_frames": TOL_FRAMES,
           "teacher_forced_kernel_launches": tf_launches,
           "teacher_forced_max_abs_err_vs_plain": tf_err,
           "tol_teacher": TOL_TEACHER,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    if not (enc_err <= TOL_ENCODER and frame_err <= TOL_FRAMES and
            tf_err <= TOL_TEACHER and tf_launches == 3 * hp.n_encoder_layer):
        raise AssertionError("kernel path disagrees with the plain path: %s"
                             % row)
    del plain

    # decoder dropout on (the reference's sampling mode)
    gen = torch.Generator("cuda").manual_seed(seed)
    before = mha_forward.launches
    tic = time.perf_counter()
    out_d = synthesize_batch(model, batch, hp, deterministic=False,
                             generator=gen, collect_alignments=False,
                             max_frames=frames)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - tic
    if not np.isfinite(out_d["mel_aft"]).all() or \
            mha_forward.launches - before != hp.n_encoder_layer:
        raise AssertionError("dropout-on decode failed")
    emit({"phase": "main_path_dropout", "wall_s": wall_d,
          "frames_per_s": int(np.sum(out_d["generated_lengths"])) / wall_d,
          "kernel_launches": mha_forward.launches - before})
    profile_phase(model, hp, batch)
    return model, launches


def profile_phase(model, hp, batch, frames=64):
    """Where a short synthesis call spends its time: device busy time (sum
    of CUDA kernel times from torch.profiler) against the unprofiled wall
    time of the same call, kernel launches per frame, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def call():
        synthesize_batch(model, batch, hp, deterministic=True,
                         collect_alignments=False, max_frames=frames)
        torch.cuda.synchronize()

    call()
    tic = time.perf_counter()
    call()
    wall_ms = (time.perf_counter() - tic) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    emit({"phase": "profile", "frames": frames, "B": 8,
          "wall_ms_unprofiled": wall_ms,
          "device_busy_ms": busy_ms if kernels else None,
          "device_idle_share": 1 - busy_ms / wall_ms if kernels else None,
          "kernel_launches": launches,
          "launches_per_frame": launches / frames,
          "top_kernels": [{"name": e.key[:80], "count": e.count,
                           "ms": e.self_device_time_total / 1e3}
                          for e in top]})


# ---------------------------------------------------------------------------
# phase 5: the CLI
# ---------------------------------------------------------------------------

def cli_phase(model, out_dir):
    from few_shot_transformer_tts_torch import synthesize as cli
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "model.ckpt-0")
    torch.save({"model": model.state_dict(), "optim": {},
                "sched": {"last_epoch": 0}, "step": 0}, ckpt)
    with open(os.path.join(out_dir, "script.txt"), "w",
              encoding="utf-8") as f:
        f.write("spk0_0|100|hello world, this is a test.|en-us\n"
                "spk1_0|100|bonjour tout le monde|fr-fr\n")
    with open(os.path.join(out_dir, "lang_id.json"), "w") as f:
        json.dump({"en-us": 0, "fr-fr": 1}, f)
    with open(os.path.join(out_dir, "spk_id.json"), "w") as f:
        json.dump({"spk0": 0, "spk1": 1}, f)
    wav_dir = os.path.join(out_dir, "synth")
    before = mha_forward.launches
    tic = time.perf_counter()
    cli.main(["--checkpoint", ckpt, "--script",
              os.path.join(out_dir, "script.txt"), "--data-dir", out_dir,
              "--output-dir", wav_dir, "--deterministic",
              "--hparams", "max_generation_frames=64"])
    wall = time.perf_counter() - tic
    files = sorted(os.listdir(wav_dir))
    for name in ("spk0_0", "spk1_0"):
        for ext in (".npy", ".wav"):
            if name + ext not in files:
                raise AssertionError("CLI did not write %s%s: %s"
                                     % (name, ext, files))
    mel = np.load(os.path.join(wav_dir, "spk0_0.npy"))
    if mel.shape != (64, 80) or not np.isfinite(mel).all():
        raise AssertionError("CLI mel has shape %s" % (mel.shape,))
    emit({"phase": "cli", "wall_s": wall, "files": files,
          "kernel_launches": mha_forward.launches - before})
    os.remove(ckpt)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out-dir",
                        default=os.path.join(ROOT, "build", "chip_smoke"))
    args = parser.parse_args()

    # phase 1: the card
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    resolve_device("cuda")   # TF32 off for fp32 products and convolutions
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # phase 2: build
    tic = time.perf_counter()
    lib = cuda_build.build("mha_fwd")
    build_s = time.perf_counter() - tic
    log = lib.with_suffix(".log")
    ptxas = [l.strip() for l in log.read_text().splitlines()
             if "registers" in l or "spill" in l] if log.exists() else []
    emit({"phase": "build", "source": "few_shot_transformer_tts_torch/csrc/"
          "mha_fwd.cu", "seconds": build_s, "ptxas": ptxas})

    rows = kernel_phase(args.seed)
    model, launches = main_path_phase(args.seed)
    cli_phase(model, args.out_dir)

    enc = rows["encoder"]
    emit({"kernels": [{
        "name": "mha_forward", "route": "cuda",
        "source": "few_shot_transformer_tts_torch/csrc/mha_fwd.cu",
        "replaces": "few_shot_transformer_tts_tpu/ops/"
                    "pallas_attention_train.py:421",
        "launches": launches, "max_abs_err": enc["max_abs_err_o"],
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": enc["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
