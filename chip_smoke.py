#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (few_shot_transformer_tts_torch).

    python3 chip_smoke.py [--seed 0] [--out-dir build/chip_smoke]
                          [--phases all] [--parent-decoder PATH]
                          [--parent-wide PATH] [--parent-ln PATH]

Needs one CUDA card, nvcc and the repository checkout; imports nothing of
JAX.  Phases, each printed as one JSON line on stdout (any failure is an
uncaught exception and a non-zero exit):

  1. device: the card's name and power limit (nvidia-smi).
  2. build: nvcc builds every csrc/*.cu for sm_90a (the attention sources
     once per head dim, 32 to 256; mha_wide.cu, the head dims above 256,
     once), one process per library, all at once; seconds and each
     library's ptxas resource summary.
  3. kernel_check: the CUDA attention forward against its plain PyTorch
     version on the card, bf16, at the three flagship synthesis call shapes
     (encoder self-attention, decoder causal, cross-attention, B=8) and edge
     shapes (Tk = 2048, Tq = 600, Tk not a multiple of the 64-key tile),
     one fp32 case, and F5-TTS's DiT rows (both CFG halves of one row,
     B=2, at its longest and shortest rows, 2,077 and 430 frames, C=1024
     in 16 heads of 64, no mask).  Max abs error of o and lse against the
     stated tolerances; kernel, plain and scaled_dot_product_attention
     times (CUDA events, warm L2 as on the main path, where the projection
     has just written q/k/v) beside the byte/FLOP bound, the kernel's time
     over SDPA's (ms_over_library) and the bound's share of it
     (bound_share).
  4. train_kernel_check: the training kernels against their plain versions
     at the three flagship train shapes (B=16, T_in=192, T_out=448), bf16,
     plus an fp32 case and edge cases (causal Tq=600, Tk=77, a causal D=64
     T=77, one 50-key tile held at TOL_L2, and the learnable corpus'
     lattice of phase 16: T_in 32 with rows of length 0, T_out 64 at B=92
     and 128 at B=46): mha_forward at dropout 0.1
     (same seed, so the same mask), mha_backward at rate 0 and 0.1 (dq, dk,
     dv; a second call must give the same bits).  Each row: error against
     tolerance, kernel / plain / library ms, bound ms and what binds it,
     ms_over_library, bound_share, launches per train step.
  4a. ln_kernel_check: layer_norm_backward (csrc/layernorm_bwd.cu, one
     cooperative launch) against its plain version at the train step's
     shapes, 3072x512 and 7168x768 bf16, and at 7 x 48, 7168 x 768 fp32,
     7169 x 768 (rows ragged against the blocks), 3 x 768 (fewer rows than
     blocks), C=44 bf16 (the scalar-load variant), a misaligned x view
     (scalar too) and 2049 x 1024 fp32: errors against TOL_LN, a second
     call the same bits, the launch plan and its variant, kernel / plain /
     aten ms warm, the kernel cold (the L2 flushed before each call,
     outside the span timed: l2_flusher) by CUDA events and by the
     profiler against the bytes bound, the kernel's stages from its trace
     stamps, the wrapper's host time per call; the plain LayerNorm
     forward's kernels per call (profiler).  With ``--parent-ln PATH`` (a
     parent commit's csrc/layernorm_bwd.cu) it builds that library too and
     times parent, change, change, parent at the two train shapes, warm,
     cold and host time, in this call (the change must be no slower warm
     or cold), and phase 9 profiles one more step with the parent's
     kernel in place.
  4b. head_dim_check: the attention kernels at the head dims the flagship
     widths give with other head counts, bf16, B=16 train shapes, as in
     phase 4 (TOL_TRAIN, TOL_L2, a repeated backward bit-identical, kernel
     / plain / SDPA ms, bound): n_attention_head=4 (encoder D=128, decoder
     causal and cross D=192), 768 wide with 16 heads (D=48, padded to the
     D=64 kernel), 512 wide with 2 heads (D=256, the 32-row tiles); D=160
     and 224 at small shapes; one fp32 case (D=128); above 256 the
     run-time head dim of csrc/mha_wide.cu (bf16 on the tensor cores; o
     held in L2 at every key count, TOL_L2["o_final_max"], since those
     kernels round p at the row's final max): 2 heads at 768 (D=384, decoder causal and cross), 1
     head at 512 (encoder D=512) and at 768 (decoder causal D=768) at the
     B=16 train shapes, at small shapes D=288 (576 wide, 2 heads; cross,
     and causal with T=141), D=320 (640 wide, 2 heads, one key tile) and
     D=1024 (1 head, causal), and an fp32 case at D=384; the bf16 wide
     calls must launch only csrc/mha_wide.cu's tensor-core kernels
     (torch.profiler's kernel names; with cuobjdump, mma instructions in
     each one's SASS); a head dim above 1024 must raise ValueError naming
     the limit.  With ``--parent-wide PATH`` (a parent commit's
     csrc/mha_wide.cu) it builds that library too and times parent,
     change, change, parent at the four wide train shapes, forward and
     backward, rates 0 and 0.1, in this call; the change must be faster in
     each.
  5. decode_kernel_check: the fused decode step (csrc/decoder_step.cu)
     against its plain PyTorch version on the card at the flagship synthesis
     shape (6 layers, C=768, 8 heads, B=8, bf16, the flagship model's
     stacked weights, cache of 512, memory 192 padded to 256) at steps 0, 1,
     255, 256 and 511, the same weights as 2 heads (D=384), its first layer
     alone, the first layer over a cache of 16,640 positions at step 16,500
     (2 rows; held to the plain math in float64, see decode_plain_f64), an
     fp32 case and a small-width case (C=128, 4 heads, D=32; 3 rows, and
     20 rows in three passes of 8 at the six-layer bound).  Three
     launches on the same inputs must agree bit for bit; errors (max, L2,
     and per attention row) against the stated tolerances (TOL_DECODE);
     kernel and plain ms per frame beside the bytes bound, the per-stage
     timeline, the grid barriers one frame passes, the wrapper's host time,
     and the eager ``decode_step``'s device time per frame for context (no
     single PyTorch call computes a frame, so no library time).  With
     ``--parent-decoder PATH`` (a parent commit's csrc/decoder_step.cu) it
     builds that kernel too and times parent, change, change, parent at
     steps 0, 256 and 511 in this call.
  6. main_path: the flagship default_config() (6+6 layers, 512/768, 8 heads,
     80 mels) with weights from --seed through numpy, stop bias -1e4 so every
     row decodes to the cap; synthesize_batch at B=8, T_in=192, 512 frames,
     deterministic.  The kernel must launch exactly 6 times (one per encoder
     layer); the encoder output and the first 32 frames must match the plain
     attention path on the card; frames/s, RTF, encoder ms.  The
     teacher-forced forward (18 launches: encoder, decoder causal and
     cross-attention) must match the plain path too.  Then the same
     call once with decoder dropout on, and a torch.profiler window of 64
     frames (device busy time against wall time, launches per frame).
  7. main_path_fused: the same call with ``use_pallas_decode=True``: one
     decoder_frame_step launch per frame (512) and 6 attention launches; the
     same call again gives the same mels and lengths bit for bit; the first
     32 frames within TOL_FRAMES of the eager path; frames/s, RTF, and a
     64-frame profiler window.  Then the fused loop's CUDA graph of the
     small ops between two kernels, at flagship B=32 and ljspeech B=1
     (padded to 8): its frames against the same chain run eagerly on the
     card, bit for bit, at caps of 45 and 125 frames; host us a frame,
     capture ms and frames/s to caps of 896 and 517, graphed against the
     eager chain.
  8. cli: a reference-format checkpoint of the random weights, a 2-line
     script and the id maps through ``python -m
     few_shot_transformer_tts_torch.synthesize`` (in-process, 64 frames),
     once as it is and once with ``--hparams use_pallas_decode=True``
     (the fused step must launch); the .npy and .wav files must exist.
  8a. eval_service: the eval service CLI (``python -m
     few_shot_transformer_tts_torch.eval``, in-process) at the flagship
     width over one model dir holding the same random weights as a torch
     file (step 10000), a JAX msgpack file (20000) and a two-rank sharded
     .d dir (30000), on 16 synthetic utterances over 2 languages (2
     batches of 8 a checkpoint, 256-frame cap, decoder dropout on;
     --gpu_vocoder at step 10000): each format loads the source's state
     dict bit for bit; .npy, .wav and _trim.wav for every sample; a finite
     mse_dtw per language and step; 6 mha_forward launches per
     synthesize_batch; a spawn saver pool; seconds per checkpoint (load,
     generation, vocoder, DTW, the wait for the pool) beside the card's
     name and power limit, and the seconds to pickle one B=8, 512-frame
     batch's results for the pool.
  9. train: the flagship config, bf16, weights from --seed, one synthetic
     batch at B=16, T_in=192, T_out=448.  One step at dropout 0 through the
     kernels against the same step through the plain attention and
     LayerNorm paths (loss and every gradient leaf, bf16 and fp32, with
     8 heads and with 4: head dims 128 and 192, TOL_STEP); then 10
     Adam steps at the default dropout rates with 18 mha_forward, 18
     mha_backward and 32 layer_norm_backward calls in every step, finite
     and falling losses; sec/step, audio s/s, MFU, peak memory, and a
     torch.profiler window of one step (with the LayerNorm backward's
     device ms and launches in it).
  10. train_cli: ``python -m few_shot_transformer_tts_torch.train`` in-process
     on a tiny synthetic corpus the script writes (small widths, 4 heads:
     head dims 32 and 48): 3 steps with a checkpoint, then a resume for 1
     more step.
  11. dsp_kernel_check (after phase 4): the fused STFT -> mel kernel
     (csrc/frame_mel.cu) against its plain version on voice-like audio
     from --seed: 16 utterances of 10 s (BT = 12,816 frames), 3 of 1.234 s
     (99 frames) and one of 0.4 s (33 frames), one launch each;
     max and mean errors against TOL_MEL, kernel / plain ms, the rfft
     route's ms as the library time, the operations bound.  Then
     melspectrogram(use_pallas=True) against numpy's get_spectrograms on
     one utterance, and the kernel's main path: one counted batched
     melspectrogram call (melspectrogram_batch).
  12. adam_kernel_check: the fused Adam kernel (csrc/fused_adam.cu) on the
     flagship's 37 kernel leaves (61.7M elements) in one adam_leaves call,
     one launch, against its plain version, bit for bit; kernel / plain /
     torch.optim.Adam(fused=True) ms beside the bytes bound.
  13. train_fused_adam (after phase 9): phase 9's 10 steps with
     use_fused_adam=True: 18/18/32 attention and LayerNorm
     kernel calls and 1 fused_adam_step launch (adam_leaves over the 37
     leaves) per step, finite and falling losses, sec/step beside
     phase 9's, a profiled step, and one FusedAdam step against
     torch.optim.Adam loaded from its state dict (TOL_ADAM_STEP), with the
     host time of each.
  14. vocode (after phase 7): vocode_batch on the eager synthesis mels
     (B=8, 512 frames, 60 Griffin-Lim iterations): seconds, audio s/s, the
     numpy mel2wav's seconds for one utterance on the host, two calls the
     same bits, and at n_iter=2 one row against numpy by envelope
     correlation.
  15. corpus: the corpus packer end to end.  Raw LJSpeech, thorsten and
     CSS10 German layouts from --seed (22,050 Hz int16; 120 voice-like
     utterances of 1.5-18 s each, about an hour in all; in each a gap
     reject and two length rejects, in thorsten and CSS10 a digit row)
     through the port's readers and ``python -m
     few_shot_transformer_tts_torch.corpora.process_corpus``: trim and meta
     in-process, then the mels stage twice, ``--device cpu`` (the numpy
     pool) as its own process, as a user runs it, into one copy of the tree,
     and the default ``--device cuda`` in-process into another (one
     fused_frame_mel launch a batch, no frame past an utterance's end, and
     no other kernel), then merge and stats for both.  The two packed trees
     must hold the same metadata, id maps and lang_stat.tsv, and every mel
     the same shape within TOL_MEL_NUMPY of numpy's; the wall time of each
     stage (as the CLI prints it) and each mels path's audio s/s beside the
     card's name and power limit, and the stage's frames with the kernel's
     bound over them.  The largest LJSpeech batch through
     fused_frame_mel_ragged against its plain version (TOL_MEL), with
     kernel / plain / rfft-route ms and the bound: the kernel line's times;
     then a batch of utterances voiced to their edges (a trimmed one's
     silent margins hide a frame read from the wrong row) against the
     plain version (TOL_MEL); each row of both must be the kernel's mel of
     that row alone, bit for bit.  Then ``python -m
     few_shot_transformer_tts_torch.train`` in-process for 3 steps of the
     flagship default_config() on the kernel-built packed tree (overrides:
     bucket_size and data_warmup_steps only): finite losses.
  16. converge: the convergence path at the flagship width.  The learnable
     corpus (``tools/make_learnable_corpus.py``: 660 train and 24 eval
     rows), then ``python -m few_shot_transformer_tts_torch.train`` as a
     process on the card (default_config() widths, the data and schedule
     hparams of converge_r05/hparams_cli.txt: ``converge_run.
     LEARNABLE_HPARAMS``; en-us and de-de, 1000 steps, a checkpoint every
     500, written by the async checkpointer), and while it runs the eval
     service (``python -m few_shot_transformer_tts_torch.eval``) as a
     second process on the card watching the same model dir, scoring both
     checkpoints as they land.  Then ``convergence.py`` in-process on
     ckpt-1000: a deterministic decode on the eager loop and one through
     the fused ``decoder_frame_step``, their mha_forward and
     decoder_frame_step launches counted (the kernels line's
     ``converge_report`` path).  Gates: every [Step N] loss finite; the
     mse_loss window mean over steps 901-1000 at most CONVERGE_MSE_GATE
     (2x the JAX package's flagship record at those steps); a finite
     mse_dtw for en-us and de-de at both checkpoints; no ``.tmp`` file
     left in the model dir; the eager and fused decodes of the same length
     on at least CONVERGE_SAME_LENGTH of the samples (each sample's two
     lengths and the largest mel difference over their common frames
     printed).  Also printed: s/step (the median of the logged steps
     100-1000, and apart while the watcher scored a checkpoint and while it
     did not), the eval service's seconds per checkpoint, the phase's
     seconds, the card's name and power limit.
  17. ddp: data-parallel training (DistributedDataParallel) at the
     flagship default_config(), bf16, dropout 0, on phase 9's batch.
     (a) World 1 over NCCL in this process: 10 steps through the
     DDP-wrapped step in turns with the same steps unwrapped; losses and
     gradients within TOL_STEP of them, 18/18/32 attention and LayerNorm
     kernel launches per DDP step, the median sec/step of steps 3-10 of
     each (DDP's cost at world 1).  (b) World 2 over gloo, both ranks on
     cuda:0 (one card cannot host two NCCL ranks), two spawned processes:
     the batch's rows split 7/9, each rank's cropped to its own padded
     shape, 3 steps with use_fused_adam (one fused_adam_step launch per
     step on each rank); per-step losses equal on both ranks and within
     TOL_STEP of a world-1 run over the whole batch, the parameters after
     3 steps equal on both ranks and, leaf by leaf, within TOL_STEP's
     gradient bar of that run, or twice the leaf's shift between two
     world-1 runs that differ only in zero padding where that is wider.  The
     host ms of a checkpoint at that state: rank 0's share of a world-2
     sharded save beside a single-file save.  (c) The train CLI under
     ``torchrun --nproc_per_node 2 ... --multihost --dist_backend gloo``
     at phase 10's widths: 2 steps with a checkpoint at 2, a resume to 4;
     model.ckpt-2.d and model.ckpt-4.d hold one shard file per rank, each
     a proper subset, every element once; feeder_0.pkl and feeder_1.pkl; a
     world-1 run (in-process, no --multihost) loads model.ckpt-4.d; no
     .tmp left.  The launches of (a)'s DDP steps and of (b)'s ranks are
     the kernels line's ``ddp`` path.  A gloo number from one card is not
     multi-GPU scaling.
  18. remat: hp.remat at the flagship (bf16, phase 9's batch, dropout 0.1,
     one generator a step): 10 steps with remat off and on from one set of
     weights; the first step's loss and every gradient within TOL_STEP
     (the count of leaves bit for bit printed), the peak memory of a
     steady step (max_memory_allocated, reset between), the median
     sec/step of steps 3-10, launches a step (18/18/32 off, 36/18/32 on:
     each attention forward recomputed once); one step of each with
     use_fused_adam (one fused_adam_step launch each, parameters after it
     within TOL_STEP's gradient bar).  The remat steps' launches are the
     kernels line's ``remat`` path.
  19. runtime: the train CLI at phase 10's widths (prenet 1024, so one
     leaf takes the fused Adam kernel; use_fused_adam) on a mels.zip
     corpus: --profile_dir with --profile_step 3 --profile_n_steps 2 (one
     trace, trace_rank0_steps3-4.json, whose spans are the steps 3 and 4
     and whose kernels include the attention, LayerNorm and Adam kernels);
     --mirror_interval 2 and a fault in the optimizer step of step 5,
     after the kernel leaves took their update (the live state
     half-updated): the crash checkpoint is the mirror's model.ckpt-4, and
     a resume from it runs to 6; the corpus' store read through the native
     reader (no zipfile read).  Then the Feeder at the flagship lattice on
     a mels.zip of 2000 [448, 80] fp32 mels: its queue depth before each
     of 20 flagship steps, the waits for a batch, and entries a second
     read through the store by 1 and 4 threads, native and zipfile, in
     turns.  The CLI runs' launches are the kernels line's ``runtime``
     path.
  20. tp: tensor parallelism at the flagship (bf16, phase 9's batch, fused
     Adam): the attention kernels on 4 of 8 heads with head offset 4 at
     the decoder's causal train shape, rate 0.1, bit for bit the 8-head
     call's heads and within TOL_TRAIN of the plain version; then two
     spawned ranks over gloo on cuda:0, grid data=1, model=2, 3 steps at
     dropout 0 and at 0.1 against world 1 in this process: losses equal on
     both ranks and within TOL_STEP; the first step's gathered gradients
     within TOL_STEP's gradient bar, leaf by leaf; the gathered parameters
     after 3 steps, on the elements whose first-step gradient stands clear
     (4x) of its rounding noise (the farthest that swapping in the plain
     versions of the attention and LayerNorm kernels, or at dropout 0
     padding or reversing the batch, moves it in world 1; at least 75% of
     the elements), within TOL_STEP's gradient bar or twice the farthest a
     swap moves them, leaf by leaf (ddp (b)'s padding bar over every swap;
     the rest held through their gradients); every attention call on 4
     heads at the rank's offset, 18/18/32/1 launches a step a rank; a TP
     sharded checkpoint (each file a proper
     subset of the elements, each element once) loaded at world 1 to the
     gathered parameters, and a step from it.  The ranks' launches are
     the kernels line's ``tp`` path; gloo through one card is no scaling
     number.

The script's seconds, then a {"kernels": [...]} line (six kernels), and last
{"ok": true,
"device": {...}}.
``--phases`` (comma-separated) runs a subset, for debugging.
"""

import argparse
import contextlib
import copy
import functools
import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from few_shot_transformer_tts_torch.config import default_config
from few_shot_transformer_tts_torch.infer import synthesize_batch
from few_shot_transformer_tts_torch.infer.synthesize import (
    _FusedFrames, _fused_loop, _steps, matmul_weights_in,
    prepare_decode_inputs)
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.common import (length_mask,
                                                          padding_bias)
from few_shot_transformer_tts_torch.models.tacotron import (compute_loss,
                                                            init_weights_)
from few_shot_transformer_tts_torch.infer import vocode_batch
from few_shot_transformer_tts_torch.ops import cuda_build, dsp, dsp_torch
from few_shot_transformer_tts_torch.ops import decode as decode_ops
from few_shot_transformer_tts_torch.ops import layernorm as layernorm_ops
from few_shot_transformer_tts_torch.ops import mha as mha_ops
from few_shot_transformer_tts_torch.ops.decode import (
    STAGES, decoder_frame_step, decoder_frame_step_plain, project_memory,
    stack_decoder_params)
from few_shot_transformer_tts_torch.ops.fused_adam import (
    FusedAdam, adam_leaf_plain, adam_leaves, kernel_leaf_params)
from few_shot_transformer_tts_torch.ops.layernorm import (
    layer_norm_backward, layer_norm_backward_plain)
from few_shot_transformer_tts_torch.ops.mel import (
    fused_frame_mel, fused_frame_mel_plain, windowed_frames)
from few_shot_transformer_tts_torch.ops.mha import (
    KERNEL_HEAD_DIMS, MAX_HEAD_DIM, dropout_keep_mask, kernel_head_dim,
    mha_backward, mha_backward_plain, mha_forward, mha_forward_plain)
from few_shot_transformer_tts_torch.train import flax_msgpack
from few_shot_transformer_tts_torch.train.checkpoint import (
    checkpoint_format, load_state, save_state)
from few_shot_transformer_tts_torch.train.converter import \
    jax_variables_from_state_dict
from few_shot_transformer_tts_torch.train.loop import (
    device_batch, make_optimizer, parallel_step_model, step_generator,
    train_step)
from few_shot_transformer_tts_torch.utils import tracing
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
TRAIN_RATE = 0.1              # hp.transformer_dropout_rate
# Training kernels against their plain versions, as max abs error over the
# largest magnitude of the plain result.  bf16: both round the outputs to
# bf16 (1 ulp = 2^-8 of the value) and round g, do/keep and ds*scale at the
# same points, but a score that lands on either side of a bf16 rounding
# boundary (the summation orders differ) moves one term by an ulp; 2e-2 is
# about 5 ulps of the largest gradient.  fp32: summation order only.
TOL_TRAIN = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# bf16 attention kernels against their plain versions in relative L2 over
# the whole output, which sees a rounding point that the max error above
# does not.  Both round q*scale, p, g, do/keep and ds*scale to bf16 at the
# same points, so outputs differ only where an fp32 sum in another order
# lands across a bf16 boundary: on the H100 the backward read l2 <= 1.9e-4
# in every case, and o <= 2.3e-5 where all keys fit one 64-key tile (with
# more tiles the kernel rounds p at a running max that the plain version
# does not see, and o reads ~1e-3).  Kernel mutants: p truncated instead
# of rounded before P.V read 1.5e-3 on the one-tile o, dss truncated read
# 4.6e-3 on dq in every case.  The bf16 kernels above head dim 256
# (csrc/mha_wide.cu) round p at the row's final max, as the plain version
# does, so their o is held at every key count, to "o_final_max": at the
# wide train shapes they read 1.0e-4 to 2.1e-4 on the H100 (their fp32
# sums over D = 384-768 flip more bf16 roundings than one tile's over
# D = 96), while the scalar kernel before them, which rounded p at a
# running max, read 1.3e-3 to 1.9e-3 there.
TOL_L2 = {"o_one_tile": 2e-4, "o_final_max": 5e-4, "grad": 1e-3}
# LayerNorm backward: dx as above; dgamma/dbeta are fp32 column sums over
# thousands of rows, in another order than the plain version's.
TOL_LN = {torch.bfloat16: {"dx": 2e-2, "dgamma": 1e-3, "dbeta": 1e-3},
          torch.float32: {"dx": 1e-4, "dgamma": 1e-4, "dbeta": 1e-4}}
# One flagship train step at dropout 0, kernels vs plain attention and
# LayerNorm paths on the card: the loss (relative) and every gradient leaf
# (|g_kernel - g_plain| / |g_plain| in L2 over the leaf).  bf16: the two
# attention paths round p at different points (unnormalized in the kernel,
# normalized in the plain path) through 12 layers forward and backward;
# fp32: summation order only.  With 4 heads (head dims 128/192) the
# encoder's pe_scale gradient, one scalar summed over the batch, cancels to
# 0.0026 (0.072 with 8 heads), so every rounding on the way moves it by a
# large share.  A leaf whose plain bf16 gradient lies further than the
# bf16 bar from its plain fp32 gradient cancels so (four_head_agreement),
# and is held in both dtypes to that shift over the bar, times 2 (two
# paths, each that far from fp32), times the tolerance; no other leaf and
# no 8-head step is widened.  On the H100 pe_scale alone qualified: plain
# bf16 0.089 from plain fp32 (bars 0.179 bf16, 3.6e-3 fp32); the kernel
# path read 0.124 in bf16 (0.005 with the LayerNorm kernel swapped for the
# plain one: its bf16 roundings move the sum) and 1.1e-3 in fp32; every
# other leaf <= 0.025 in bf16 and <= 1.2e-4 in fp32.
TOL_STEP = {torch.bfloat16: {"loss": 1e-2, "grad": 5e-2},
            torch.float32: {"loss": 1e-5, "grad": 1e-3}}
# Fused decode step, kernel vs plain version on the card, per case.  Both
# round at the same points, and the kernel is deterministic (two launches
# must agree bit for bit), but its fp32 sums run in another order than
# torch.matmul's: a sum that lands on the other side of a bf16 rounding
# boundary moves that input by one ulp (2^-8 of it), and later layers carry
# it on.  x_out, k_new, v_new: "rel" is the max abs error over the largest
# magnitude, "l2" the error's L2 norm over the plain result's.  align, a
# row of weights over the memory per (layer, row, head): "l1" is the
# largest sum over the row of |error| (a row sums to 1), "row" the largest
# error over its row's largest weight.  Padded memory columns must get
# exactly 0 and every row must sum to 1 within TOL_ROW_SUM in both.
# The one-layer and small (two-layer) bf16 cases hold the rounding points:
# they read l2 <= 8e-7, l1 and row <= 1e-5 on the H100, and each of nine
# kernel mutants (a rounding point dropped, LN eps 1e-5, padded columns
# given weight) moved the one-layer case to l2 >= 1.7e-3, l1 >= 8e-4 and
# row >= 1.3e-3.  The six-layer case bounds the drift that layers
# carry on (it read rel <= 7.1e-3, l2 <= 2.8e-3, l1 <= 0.0124, row <=
# 0.034), with about 2.5x room.  fp32 is summation order only.
TOL_DECODE = {
    "flagship_bf16": {"rel": 2e-2, "l2": 1e-2, "l1": 3e-2, "row": 8e-2},
    "one_layer_bf16": {"rel": 1e-2, "l2": 1e-4, "l1": 1e-4, "row": 1e-4},
    "small_c128_bf16": {"rel": 1e-2, "l2": 1e-4, "l1": 1e-4, "row": 1e-4},
    "flagship_fp32": {"rel": 1e-5, "l2": 2e-6, "l1": 1e-5, "row": 1e-5}}
TOL_ROW_SUM = 2e-6
# fused_frame_mel, kernel vs plain version on the card, on the normalised
# mel ([-4, 4]).  The kernel's FFT and the plain version's DFT product sum
# in fp32 in other orders, so a magnitude near a bf16 rounding boundary may
# round to its neighbour: one bf16 ulp (0.4%) moves a mel band that bin
# carries alone by 0.034 dB, 2.7e-3 on this scale; such flips are rare, so
# the mean stays small.  The FFT kernel read max <= 1.8e-3 and mean <=
# 1.5e-6 on the H100 (the DFT kernel before it 9.8e-4 and 1.7e-6; the CPU
# test: 1.2e-3 and 2.2e-6 between the plain version and the TPU kernel in
# interpret mode); kernel mutants: the bf16 rounding of the magnitude
# skipped read mean 2.8e-4, a twiddle's sign flipped in one FFT stage
# 0.59, 32 taps of the DFT kernel dropped 2.7e-3.
TOL_MEL = {"max": 1e-2, "mean": 1e-5}
# melspectrogram(use_pallas=True) against numpy's float64 get_spectrograms:
# the bar of tests/test_mel_pallas.py
TOL_MEL_NUMPY = {"max": 0.05, "mean": 0.01}
# fused_adam_step vs adam_leaf_plain: each operation is rounded once in
# both, in the same order (the kernel uses __fmul_rn / __fadd_rn /
# __fdiv_rn / __fsqrt_rn, so nvcc contracts nothing into an FMA): the same
# bits
TOL_ADAM_ULPS = 0
# One FusedAdam step against torch.optim.Adam (foreach) from the same
# state and gradients, max |p_fused - p_adam|: Adam's lerp and its
# sqrt(v)/sqrt(bc2) denominator round differently from b1 m + (1 - b1) g
# and r sqrt(v), a few ulps of an update of about lr, plus one rounding of
# p (|p| < 8 at init: one ulp is at most 4.8e-7)
TOL_ADAM_STEP = 1e-6
DECODE_WEIGHTS = ("w_qkv", "w_out", "w_q", "w_xout", "w_ffn1", "w_ffn2")


# about 0.1 s at the H100's clocks: longer than the host takes to queue any
# timed loop below
SLEEP_CYCLES = 200_000_000


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn over iters launches, after a warm-up.  A
    sleep kernel holds the card while the host queues every launch, so the
    events time the device work and not the host's launch rate (a kernel of
    tens of microseconds is otherwise timed at its wrapper's host cost)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def l2_flusher(dirty=False, flush_bytes=64 << 20):
    """A function that flushes the L2 cache: it writes ``flush_bytes`` (more
    than the H100's 50 MB L2), then reads as many of another buffer, so that
    the next kernel finds none of its data in L2 and no dirty line whose
    write-back it would pay for; ``dirty``: the write alone."""
    buf = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    other = torch.ones_like(buf)

    def flush():
        buf.fill_(1.0)
        if not dirty:
            other.sum()
    return flush


def cold_ms(fn, iters, dirty=False):
    """Mean device time of fn with the L2 cache flushed before each call
    (l2_flusher), the flush outside the span timed: CUDA events around the
    call alone, queued while a sleep kernel holds the card."""
    flush = l2_flusher(dirty)
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def cold_kernel_ms(fn, name, iters=20, tries=3):
    """Mean device duration of the kernels whose name holds ``name`` that fn
    launches, the L2 flushed before each call (torch.profiler: the kernels'
    own time, without the launch around them that CUDA events include).
    The profiler may record none of a window's launches: then the window
    is taken again, up to ``tries`` times, and None means not measured."""
    from torch.profiler import ProfilerActivity, profile
    flush = l2_flusher()
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_kernels(prof)[0]
                  if name in e.key and e.count]
        if events:
            return sum(e.self_device_time_total / e.count
                       for e in events) / 1e3
    return None


def host_us(fn, n=50):
    """Host microseconds per call of fn while a sleep kernel holds the card
    (so no call waits on the device)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    tic = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - tic) / n * 1e6
    torch.cuda.synchronize()
    return us


def kernel_split_ms(fn, iters=10):
    """Mean device ms of each kernel that fn launches (torch.profiler), by
    the kernel's name up to its template arguments, with the number of
    launches the profiler recorded (it may drop some of the iters)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {kernel_name(e.key):
            {"ms": e.self_device_time_total / 1e3 / e.count,
             "launches_recorded": e.count}
            for e in device_kernels(prof)[0] if e.count}


def kernel_name(key):
    """A device kernel's name without its namespaces, template arguments
    and parameters ("(anonymous namespace)::wide_delta((anonymous
    namespace)::Args, int)" -> "wide_delta")."""
    head = re.split(r"[<(]", key.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0]
    return head.split("::")[-1].split()[-1]


def timings(ms, plain_ms, library_ms, bound_ms):
    """A kernel row's times: kernel, plain and library ms, the bound, the
    kernel's time over the library call's and the bound's share of it."""
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "ms_over_library": ms / library_ms if library_ms else None,
            "bound_share": bound_ms / ms}


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
    l2_o = l2_err(o, o_ref)
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
           "l2_err_o": l2_o, "tol_o": tol["o"], "tol_lse": tol["lse"],
           "ok": ok, **timings(ms, plain_ms, library_ms, bound_ms),
           "bound_by": bound_by, "bytes": nbytes, "flops": flops}
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
    # F5-TTS's DiT (f5tts_base.flow_synth): one call a row over its own
    # frames and both CFG halves, bidirectional over C=1024 in 16 heads of
    # 64, at the traffic's longest and shortest rows
    for name, t in (("f5_dit", 2077), ("f5_dit_short", 430)):
        rows[name] = check_kernel(name, rng, 2, t, t, 1024, 16, False,
                                  None)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def rel_err(got, want):
    """max |got - want| over max |want|."""
    return abs_err(got, want) / max(want.float().abs().max().item(), 1e-30)


def mha_backward_bound(b, tq, tk, c, heads, causal, use_bias, dtype):
    """Least time for the backward: q, k, v, o, do read and dq, dk, dv
    written once (plus lse and bias); five products (s, do.v^T, dv, dq, dk)
    over the pairs this mask needs."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (4 * b * tq * c + 4 * b * tk * c) * elt + b * tq * heads * 4 + \
        (b * tk * 4 if use_bias else 0)
    pairs = b * tq * (tq + 1) // 2 if causal else b * tq * tk
    flops = 10.0 * pairs * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations"), nbytes, flops


def layernorm_bound(n, c, dtype):
    """x, dy read and dx written once, gamma read and dgamma/dbeta written
    once; about 16 fp32 operations per element outside the tensor cores."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 3 * n * c * elt + 3 * c * 4
    flops = 16.0 * n * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS_PER_S[torch.float32] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations"), nbytes, flops


def sdpa_leaves(q, k, v, bias, heads, dtype):
    """q/k/v as [B,H,T,D] leaves and the additive mask for SDPA."""
    b, tq, c = q.shape
    tk, d = k.shape[1], c // heads
    leaf = lambda t, n: t.detach().view(b, n, heads, d).transpose(
        1, 2).requires_grad_()
    mask = bias[:, None, None, :].to(dtype) if bias is not None else None
    return leaf(q, tq), leaf(k, tk), leaf(v, tk), mask


def check_train_attention(name, rng, b, tq, tk, c, heads, causal, lengths,
                          launches_per_step, cross=False,
                          dtype=torch.bfloat16, iters=20):
    """mha_forward and mha_backward at rates 0.1 and 0 against the plain
    versions with the same seed (so the same mask)."""
    q, k, v, bias = attention_inputs(rng, b, tq, tk, c, cross, lengths,
                                     dtype)
    use_bias = bias is not None
    scale = (c // heads) ** -0.5
    seed = torch.tensor([int(rng.randint(0, 2 ** 31)) << 20],
                        dtype=torch.int64, device="cuda")
    args = (q, k, v, bias, heads, causal, scale, use_bias)
    tol = TOL_TRAIN[dtype]
    shape = {"case": name, "dtype": str(dtype), "B": b, "Tq": tq, "Tk": tk,
             "C": c, "H": heads, "D": c // heads,
             "kernel_D": kernel_head_dim(c // heads), "causal": causal,
             "bias": use_bias, "launches_per_train_step": launches_per_step}
    qh, kh, vh, mask = sdpa_leaves(q, k, v, bias, heads, dtype)
    rows = {}

    bound_ms, bound_by, nbytes, flops = attention_bound(
        b, tq, tk, c, heads, causal, use_bias, dtype)
    for rate in (TRAIN_RATE, 0.0):
        o, lse = mha_forward(*args, rate=rate, seed=seed)
        o_ref, lse_ref = mha_forward_plain(*args, rate, seed)
        torch.cuda.synchronize()
        err_o = rel_err(o, o_ref)
        err_lse = (lse - lse_ref).abs().max().item()
        row = dict(shape, phase="train_kernel_check", kernel="mha_forward",
                   rate=rate, rel_err_o=err_o,
                   max_abs_err_o=abs_err(o, o_ref), max_abs_err_lse=err_lse,
                   l2_err_o=l2_err(o, o_ref), tol_o=tol,
                   tol_lse=TOL_BF16["lse"],
                   kept_share=dropout_keep_mask(
                       seed, b, heads, tq, tk, rate).float().mean().item(),
                   kernels_ms=kernel_split_ms(
                       lambda: mha_forward(*args, rate=rate, seed=seed)),
                   **timings(
                       cuda_ms(lambda: mha_forward(*args, rate=rate,
                                                   seed=seed), iters),
                       cuda_ms(lambda: mha_forward_plain(*args, rate, seed),
                               max(iters // 5, 3)),
                       cuda_ms(lambda: F.scaled_dot_product_attention(
                           qh, kh, vh, attn_mask=mask, is_causal=causal,
                           scale=scale, dropout_p=rate), iters),
                       bound_ms),
                   bound_by=bound_by, bytes=nbytes, flops=flops)
        row["tol_l2_o"] = None   # o in L2 where p rounds at the final max
        if dtype == torch.bfloat16 and tk <= 64:
            row["tol_l2_o"] = TOL_L2["o_one_tile"]
        elif dtype == torch.bfloat16 and \
                shape["kernel_D"] > KERNEL_HEAD_DIMS[-1]:
            row["tol_l2_o"] = TOL_L2["o_final_max"]
        row["ok"] = err_o <= tol and err_lse <= TOL_BF16["lse"] and \
            (row["tol_l2_o"] is None or row["l2_err_o"] <= row["tol_l2_o"]) \
            and bool(torch.isfinite(o).all())
        emit(row)
        rows["forward" if rate else "forward_0"] = row
        if not row["ok"]:
            raise AssertionError("mha_forward disagrees with its plain "
                                 "version at %s: %s" % (name, row))

    for rate in (0.0, TRAIN_RATE):
        o, lse = mha_forward(*args, rate=rate, seed=seed)
        do = torch.randn(o.shape, device="cuda").to(dtype)
        bargs = (q, k, v, bias, seed, o, lse, do, heads, causal, scale,
                 use_bias, rate)
        got = mha_backward(*bargs)
        again = mha_backward(*bargs)
        want = mha_backward_plain(*bargs)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        errs = {"rel_err_" + n: rel_err(g, w)
                for n, g, w in zip(names, got, want)}
        abs_errs = {"max_abs_err_" + n: abs_err(g, w)
                    for n, g, w in zip(names, got, want)}
        l2_errs = {"l2_err_" + n: l2_err(g, w)
                   for n, g, w in zip(names, got, want)}
        # no atomics: the same inputs give the same bits
        repeat = all(torch.equal(g, x) for g, x in zip(got, again))
        out = F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal, scale=scale,
            dropout_p=rate)
        doh = do.view(b, tq, heads, c // heads).transpose(1, 2)
        bound_ms, bound_by, nbytes, flops = mha_backward_bound(
            b, tq, tk, c, heads, causal, use_bias, dtype)
        row = dict(shape, phase="train_kernel_check", kernel="mha_backward",
                   rate=rate, tol=tol, **errs, **abs_errs, **l2_errs,
                   **{"max_abs_" + n: w.float().abs().max().item()
                      for n, w in zip(names, want)},
                   repeat_bit_identical=repeat,
                   kernels_ms=kernel_split_ms(lambda: mha_backward(*bargs)),
                   **timings(
                       cuda_ms(lambda: mha_backward(*bargs), iters),
                       cuda_ms(lambda: mha_backward_plain(*bargs),
                               max(iters // 5, 3)),
                       cuda_ms(lambda: torch.autograd.grad(
                           out, (qh, kh, vh), doh, retain_graph=True),
                           iters),
                       bound_ms),
                   bound_by=bound_by, bytes=nbytes, flops=flops)
        row["tol_l2"] = TOL_L2["grad"] if dtype == torch.bfloat16 else None
        row["ok"] = max(errs.values()) <= tol and repeat and \
            (row["tol_l2"] is None or max(l2_errs.values()) <= row["tol_l2"]) \
            and all(bool(torch.isfinite(g).all()) for g in got)
        emit(row)
        rows["backward_%g" % rate] = row
        if not row["ok"]:
            raise AssertionError("mha_backward disagrees with its plain "
                                 "version at %s: %s" % (name, row))
    return rows


def train_kernel_phase(seed):
    """The train step's kernel calls at the flagship shapes (B=16, T_in=192,
    T_out=448), then edges and fp32."""
    rng = np.random.RandomState(seed + 10)
    enc_len = rng.randint(96, 193, 16)
    rows = {}
    rows["encoder"] = check_train_attention(
        "train_encoder", rng, 16, 192, 192, 512, 8, False, enc_len, 6)
    rows["decoder_causal"] = check_train_attention(
        "train_decoder_causal", rng, 16, 448, 448, 768, 8, True, None, 6)
    rows["cross"] = check_train_attention(
        "train_cross", rng, 16, 448, 192, 768, 8, False, enc_len, 6,
        cross=True)
    check_train_attention("train_tq600_causal", rng, 2, 600, 600, 768, 8,
                          True, None, 0, iters=5)
    check_train_attention("train_tk77_cross", rng, 3, 45, 77, 768, 8, False,
                          [77, 50, 1], 0, cross=True, iters=5)
    # head dim 64, causal, T ragged against the 64-row tiles
    check_train_attention("train_t77_causal_d64", rng, 3, 77, 77, 512, 8,
                          True, None, 0, iters=5)
    # one key tile: the forward's running max is the final one, so its p
    # rounds as the plain version's does and o is held at TOL_L2
    check_train_attention("train_tk50_one_tile", rng, 4, 45, 50, 768, 8,
                          False, [50, 31, 1, 50], 0, cross=True, iters=5)
    check_train_attention("train_encoder_fp32", rng, 16, 192, 192, 512, 8,
                          False, enc_len, 0, dtype=torch.float32, iters=5)
    # the learnable corpus' lattice (phase converge): T_in 32 (one partial
    # key tile), T_out 64 / 128 at batch_frame_limit=6000, and the Feeder's
    # batch-padding rows of length 0
    text_len = np.concatenate([rng.randint(13, 33, 45), [0]])
    check_train_attention("learnable_encoder", rng, 92, 32, 32, 512, 8,
                          False, np.concatenate([text_len, text_len]), 6,
                          iters=5)
    check_train_attention("learnable_decoder_causal_t64", rng, 92, 64, 64,
                          768, 8, True, None, 6, iters=5)
    check_train_attention("learnable_decoder_causal_t128", rng, 46, 128,
                          128, 768, 8, True, None, 6, iters=5)
    check_train_attention("learnable_cross_t128", rng, 46, 128, 32, 768, 8,
                          False, text_len, 6, cross=True, iters=5)
    return rows


# ---------------------------------------------------------------------------
# phase 4a: the LayerNorm backward kernel
# ---------------------------------------------------------------------------

def layernorm_inputs(rng, n, c, dtype, misalign=False):
    """x, gamma, beta, dy on the card; ``misalign``: x is a view 2 or 4
    bytes past a 16-byte boundary (one element into its buffer)."""
    x32 = torch.from_numpy((rng.randn(n, c) * 2 + 0.5).astype(np.float32))
    if misalign:
        x = torch.empty(n * c + 1, dtype=dtype, device="cuda")[1:].view(n, c)
        x.copy_(x32)
    else:
        x = x32.to("cuda", dtype)
    gamma = torch.from_numpy((1 + 0.1 * rng.randn(c)).astype(
        np.float32)).cuda()
    beta = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)).cuda()
    dy = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(
        "cuda", dtype)
    return x, gamma, beta, dy


def check_layernorm(name, rng, n, c, launches_per_step,
                    dtype=torch.bfloat16, iters=50, misalign=False,
                    variant="vector"):
    """layer_norm_backward against its plain version at x [n, c]: errors
    against TOL_LN, a second call's bits, the launch plan (which must take
    ``variant``), kernel / plain / aten ms warm, the kernel cold (L2
    flushed), its kernels' split, the wrapper's host time."""
    x, gamma, beta, dy = layernorm_inputs(rng, n, c, dtype, misalign)
    got = layer_norm_backward(x, gamma, dy)
    again = layer_norm_backward(x, gamma, dy)
    want = layer_norm_backward_plain(x, gamma, dy)
    torch.cuda.synchronize()
    errs = {n_: rel_err(g, w) for n_, g, w in
            zip(("dx", "dgamma", "dbeta"), got, want)}
    aligned = x.data_ptr() % 16 == 0
    plan = layernorm_ops._plan(x.device, n, c, dtype, aligned)
    # the library call: aten's LayerNorm backward from its own forward's
    # statistics (E[(x - mean)^2], so no error is compared)
    _, mean, rstd = torch.ops.aten.native_layer_norm(
        x, [c], gamma.to(dtype), beta.to(dtype), 1e-6)
    bound_ms, bound_by, nbytes, flops = layernorm_bound(n, c, dtype)
    tol = TOL_LN[dtype]
    kernel = lambda: layer_norm_backward(x, gamma, dy)
    row = {"phase": "ln_kernel_check", "kernel": "layer_norm_backward",
           "case": name, "dtype": str(dtype), "rows": n, "C": c,
           "x_aligned_16": aligned,
           "plan": {"variant": "vector" if plan.vector else "scalar",
                    **plan._asdict()},
           "launches_per_train_step": launches_per_step,
           **{"rel_err_" + k: v for k, v in errs.items()},
           "max_abs_err_dx": abs_err(got[0], want[0]),
           "max_abs_dx": want[0].float().abs().max().item(),
           **{"tol_" + k: v for k, v in tol.items()},
           "repeat_bit_identical": all(torch.equal(a, b)
                                       for a, b in zip(got, again)),
           **timings(
               cuda_ms(kernel, iters),
               cuda_ms(lambda: layer_norm_backward_plain(x, gamma, dy),
                       max(iters // 5, 3)),
               cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                   dy, x, [c], mean, rstd, gamma.to(dtype), beta.to(dtype),
                   [True, True, True]), iters),
               bound_ms),
           "bound_by": bound_by, "bytes": nbytes, "flops": flops}
    row["cold_ms"] = cold_ms(kernel, max(iters // 2, 3))
    row["cold_bound_share"] = bound_ms / row["cold_ms"]
    row["cold_dirty_ms"] = cold_ms(kernel, max(iters // 2, 3), dirty=True)
    row["cold_kernel_ms"] = cold_kernel_ms(kernel, "ln_bwd")
    row["cold_kernel_bound_share"] = bound_ms / row["cold_kernel_ms"] \
        if row["cold_kernel_ms"] else None
    if plan.grid > 1:
        row["timeline_us"] = {"warm": ln_timeline_us(x, gamma, dy, plan),
                              "cold": ln_timeline_us(x, gamma, dy, plan,
                                                     l2_flusher())}
    row["kernels_ms"] = kernel_split_ms(kernel)
    row["host_us_per_call"] = host_us(kernel)
    row["ok"] = all(errs[k] <= tol[k] for k in errs) and \
        row["repeat_bit_identical"] and row["plan"]["variant"] == variant \
        and all(bool(torch.isfinite(g).all()) for g in got)
    emit(row)
    if not row["ok"]:
        raise AssertionError("layer_norm_backward disagrees with its plain "
                             "version at %s: %s" % (name, row))
    return row


def ln_timeline_us(x, gamma, dy, plan, flush=None, reps=20):
    """Median over ``reps`` calls of the kernel's stages (its blocks'
    global-timer stamps, ops/layernorm.py TRACE_STAMPS), as µs from the
    first block's start to the last block's stamp; ``flush`` before each
    call when given."""
    names = layernorm_ops.TRACE_STAMPS
    trace = torch.zeros(plan.grid * len(names), dtype=torch.int64,
                        device="cuda")
    stages = []
    for _ in range(reps):
        if flush:
            flush()
        layer_norm_backward(x, gamma, dy, trace=trace)
        t = trace.view(plan.grid, len(names)).cpu().numpy()
        stages.append(t.max(0)[1:] - t[:, 0].min())
    return dict(zip(names[1:], (np.median(stages, 0) / 1e3).tolist()))


def parent_ln(source):
    """The parent commit's csrc/layernorm_bwd.cu (its C interface: two
    kernels, the caller's [blocks, 2, C] workspace), built here, as a
    function of layer_norm_backward's arguments that does what the parent's
    wrapper did per call (its argument checks were this one's): for the A/B
    of one call.  Returns (function, its ptxas lines)."""
    import ctypes
    out = os.path.join(ROOT, "build", "parent_ln", "liblayernorm_bwd.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    log = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                          "-o", out, source], check=True, capture_output=True,
                         text=True, timeout=600)
    ptxas = [l.strip() for l in (log.stdout + log.stderr).splitlines()
             if "registers" in l or "spill" in l or "Compiling entry" in l]
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ln_bwd.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i,
                           ctypes.c_float, p]
    lib.ln_bwd.restype = i

    def fn(x, gamma, dy, eps=1e-6):
        layernorm_ops.check_kernel_args(x, gamma, dy)
        c = x.shape[-1]
        x2 = x.reshape(-1, c).contiguous()
        dy2 = dy.reshape(-1, c).contiguous()
        rows = x2.shape[0]
        dx = torch.empty_like(x2)
        dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
        dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
        blocks = min(-(-rows // 8), 264)
        rows_per_block = -(-rows // blocks)
        blocks = -(-rows // rows_per_block)
        partial = torch.empty((blocks, 2, c), dtype=torch.float32,
                              device=x.device)
        err = lib.ln_bwd(int(x.dtype == torch.bfloat16), x2.data_ptr(),
                         gamma.contiguous().data_ptr(), dy2.data_ptr(),
                         dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                         partial.data_ptr(), rows, c, rows_per_block, blocks,
                         float(eps),
                         torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError("the parent's ln_bwd failed: %d" % err)
        return dx.reshape(x.shape), dgamma, dbeta
    return fn, ptxas


def parent_ln_ab(parent, rng, iters=50):
    """The parent's LayerNorm backward and this one at the two train
    shapes, bf16: warm and cold ms, in the order parent, change, change,
    parent, each kernel's split and the wrappers' host time, with both
    results' errors against the plain version."""
    p_fn, ptxas = parent
    rows = {}
    for name, n, c in (("ln_encoder", 16 * 192, 512),
                       ("ln_decoder", 16 * 448, 768)):
        x, gamma, _, dy = layernorm_inputs(rng, n, c, torch.bfloat16)
        want = layer_norm_backward_plain(x, gamma, dy)
        fns = (lambda: p_fn(x, gamma, dy),
               lambda: layer_norm_backward(x, gamma, dy))
        row = {"phase": "ln_kernel_check", "case": "parent_ln_ab",
               "shape": name, "rows": n, "C": c,
               "order": "parent, change, change, parent"}
        for what, timer in (
                ("warm", lambda f: cuda_ms(f, iters)),
                ("cold", lambda f: cold_ms(f, iters // 2)),
                ("cold_dirty", lambda f: cold_ms(f, iters // 2, dirty=True)),
                ("host_us", host_us)):
            t = [timer(fns[i]) for i in (0, 1, 1, 0)]
            row[what] = {"parent": [t[0], t[3]], "change": [t[1], t[2]],
                         "speedup": min(t[0], t[3]) / max(t[1], t[2])}
        row["kernels_ms"] = {"parent": kernel_split_ms(fns[0]),
                             "change": kernel_split_ms(fns[1])}
        row["rel_err_max"] = {
            who: max(rel_err(g, w) for g, w in zip(fn(), want))
            for who, fn in (("parent", fns[0]), ("change", fns[1]))}
        row["parent_ptxas"] = ptxas
        row["ok"] = row["warm"]["speedup"] >= 1 and \
            row["cold"]["speedup"] >= 1
        emit(row)
        rows[name] = row
        if not row["ok"]:
            raise AssertionError("the change is slower than the parent's "
                                 "layernorm_bwd.cu: %s" % row)
    return rows


def ln_kernel_phase(seed, parent=None):
    """layer_norm_backward at the train step's two shapes (13 and 19 calls
    per step), then edges: rows not a multiple of the blocks' rows, fewer
    rows than blocks, a ragged row (C=44 bf16: the scalar variant), a
    misaligned x, fp32 at C=768 and 1024.  With ``parent`` (parent_ln of a
    parent commit's csrc/layernorm_bwd.cu), the A/B of one call."""
    rng = np.random.RandomState(seed + 11)
    rows = {}
    rows["ln_encoder"] = check_layernorm("ln_encoder", rng, 16 * 192, 512,
                                         13)
    rows["ln_decoder"] = check_layernorm("ln_decoder", rng, 16 * 448, 768,
                                         19)
    check_layernorm("ln_rows7_c48", rng, 7, 48, 0, iters=5)
    check_layernorm("ln_decoder_fp32", rng, 16 * 448, 768, 0,
                    dtype=torch.float32, iters=10)
    check_layernorm("ln_rows7169_c768", rng, 16 * 448 + 1, 768, 0, iters=5)
    check_layernorm("ln_rows3_c768", rng, 3, 768, 0, iters=5)
    check_layernorm("ln_c44_scalar", rng, 333, 44, 0, iters=5,
                    variant="scalar")
    check_layernorm("ln_misaligned_x", rng, 1001, 768, 0, iters=5,
                    misalign=True, variant="scalar")
    check_layernorm("ln_c1024_fp32", rng, 2049, 1024, 0,
                    dtype=torch.float32, iters=5)
    rows["forward_launches"] = ln_forward_launches(rng)
    if parent:
        rows["parent_ab"] = parent_ln_ab(parent, rng)
    return rows


def ln_forward_launches(rng, calls=5, per_step=32):
    """Device kernels of one plain LayerNorm forward as a train step runs
    it (LayerNormFunction at the encoder shape, bf16, autograd on), by
    torch.profiler; ``per_step`` forwards per flagship step (one per
    layer_norm_backward call)."""
    from torch.profiler import ProfilerActivity, profile
    x, gamma, beta, _ = layernorm_inputs(rng, 16 * 192, 512, torch.bfloat16)
    x.requires_grad_()
    fn = lambda: layernorm_ops.LayerNormFunction.apply(x, gamma, beta, 1e-6)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)[0]
    per_call = sum(e.count for e in kernels) / calls
    row = {"phase": "ln_kernel_check", "case": "ln_forward_launches",
           "rows": 16 * 192, "C": 512, "kernels_per_call": per_call,
           "per_step": per_call * per_step,
           "device_ms_per_call": sum(e.self_device_time_total
                                     for e in kernels) / 1e3 / calls,
           "kernels": sorted({kernel_name(e.key) for e in kernels})}
    emit(row)
    return row


# the wide train shapes: the flagship widths with 2 heads (D=384) and 1
# (D=512, 768), at the B=16 train shapes
WIDE_TRAIN_CASES = (
    ("train_decoder_causal_d384", 768, 2, "decoder_causal"),
    ("train_cross_d384", 768, 2, "cross"),
    ("train_encoder_d512", 512, 1, "encoder"),
    ("train_decoder_causal_d768", 768, 1, "decoder_causal"))
# the kernels a bf16 call above head dim 256 may launch (csrc/mha_wide.cu)
WIDE_KERNELS = {"mha_forward": {"wide_scores_tc", "wide_pv_tc"},
                "mha_backward": {"wide_delta", "wide_ds_tc", "wide_grad_tc"}}


def sass_mma_counts(lib):
    """{kernel: mma instructions (HMMA) in its SASS} of a built library,
    from cuobjdump beside nvcc; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def wide_kernels_check(rng):
    """The bf16 calls above head dim 256 launch only the tensor-core
    kernels of csrc/mha_wide.cu (torch.profiler's kernel names), forward
    and backward at rates 0 and 0.1, and each of those kernels runs mma
    instructions (cuobjdump's SASS of the library)."""
    b, t, c, heads = 2, 130, 768, 2
    q, k, v, _ = attention_inputs(rng, b, t, t, c, False, None,
                                  torch.bfloat16)
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    args = (q, k, v, None, heads, True, (c // heads) ** -0.5, False)
    def names(fn):
        # the profiler now and then records no kernel of a window; an empty
        # record is retried, any other set is the answer
        for _ in range(3):
            got = sorted(kernel_split_ms(fn, iters=3))
            if got:
                return got
        return got

    launched = {}
    for rate in (0.0, TRAIN_RATE):
        o, lse = mha_forward(*args, rate=rate, seed=seed)
        do = torch.randn(o.shape, device="cuda").to(torch.bfloat16)
        launched["mha_forward_%g" % rate] = names(
            lambda: mha_forward(*args, rate=rate, seed=seed))
        launched["mha_backward_%g" % rate] = names(
            lambda: mha_backward(q, k, v, None, seed, o, lse, do, heads,
                                 True, args[6], False, rate))
    mma = sass_mma_counts(cuda_build.build("mha_wide"))
    by_kernel = None if mma is None else {
        name: sum(n for fn, n in mma.items() if name in fn)
        for names in WIDE_KERNELS.values() for name in names}
    row = {"phase": "head_dim_check", "case": "wide_kernels",
           "launched": launched,
           "expected": {k_: sorted(v_) for k_, v_ in WIDE_KERNELS.items()},
           "sass_mma_by_kernel": by_kernel}
    row["ok"] = all(set(names) == WIDE_KERNELS[key.rsplit("_", 1)[0]]
                    for key, names in launched.items()) and \
        (by_kernel is None or all(
            n > 0 for name, n in by_kernel.items() if name != "wide_delta"))
    emit(row)
    if not row["ok"]:
        raise AssertionError("the bf16 wide calls launched other kernels "
                             "than csrc/mha_wide.cu's tensor-core ones: %s"
                             % row)


def parent_wide(source):
    """The parent commit's csrc/mha_wide.cu (its C interface: mha_fwd's and
    mha_bwd's arguments, no workspace), built here, as (forward, backward)
    functions of mha_forward's and mha_backward's arguments (bf16, a head
    dim that is a multiple of 32 above 256): for the A/B of one call."""
    import ctypes
    out = os.path.join(ROOT, "build", "parent_wide", "libmha_wide.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                    "-I", str(cuda_build.CSRC_DIR), "-o", out, source],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(out)
    # the parent's interface: mha_fwd's and mha_bwd's of that commit, before
    # the head offset
    mha_ops._bind(lib.mha_wide_fwd, "i i p p p p p p p i i i i ll ll ll ll "
                  "ll ll f i i i u f p")
    mha_ops._bind(lib.mha_wide_bwd, "i i p p p p p p p p p p p p i i i i ll "
                  "ll ll ll ll ll ll ll ll ll f i i i u f p")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()

    def fwd(q, k, v, bias, heads, causal, scale, use_bias, rate=0.0,
            seed=None):
        b, tq, c = q.shape
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty(b, tq, heads, device="cuda")
        err = lib.mha_wide_fwd(
            1, c // heads, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ptr(bias), ptr(seed) if rate > 0 else None, o.data_ptr(),
            lse.data_ptr(), b, tq, k.shape[1], heads, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            scale, int(causal), int(use_bias), int(rate > 0),
            dropout_threshold(rate), 1.0 - rate, stream())
        if err:
            raise RuntimeError("the parent's mha_wide_fwd failed: %d" % err)
        return o, lse

    def bwd(q, k, v, bias, seed, o, lse, do, heads, causal, scale, use_bias,
            rate=0.0):
        b, tq, c = q.shape
        dq = torch.empty(q.shape, dtype=q.dtype, device="cuda")
        dk = torch.empty(k.shape, dtype=q.dtype, device="cuda")
        dv = torch.empty(k.shape, dtype=q.dtype, device="cuda")
        delta = torch.empty(b, tq, heads, device="cuda")
        err = lib.mha_wide_bwd(
            1, c // heads, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ptr(bias), ptr(seed) if rate > 0 else None, o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, tq, k.shape[1], heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), o.stride(0), o.stride(1), do.stride(0),
            do.stride(1), scale, int(causal), int(use_bias), int(rate > 0),
            dropout_threshold(rate), 1.0 / (1.0 - rate), stream())
        if err:
            raise RuntimeError("the parent's mha_wide_bwd failed: %d" % err)
        return dq, dk, dv
    return fwd, bwd


def parent_wide_ab(parent, rng, enc_len, iters=10):
    """ms of the parent's wide kernels and these at the wide train shapes,
    forward and backward at rates 0 and 0.1, in the order parent, change,
    change, parent, with both results' errors against the plain version."""
    p_fwd, p_bwd = parent
    rows = {}
    for name, c, heads, shape in WIDE_TRAIN_CASES:
        tq, tk, causal, lengths, cross = {
            "encoder": (192, 192, False, enc_len, False),
            "decoder_causal": (448, 448, True, None, False),
            "cross": (448, 192, False, enc_len, True)}[shape]
        q, k, v, bias = attention_inputs(rng, 16, tq, tk, c, cross, lengths,
                                         torch.bfloat16)
        seed = torch.tensor([int(rng.randint(0, 2 ** 31)) << 20],
                            dtype=torch.int64, device="cuda")
        args = (q, k, v, bias, heads, causal, (c // heads) ** -0.5,
                bias is not None)
        for rate in (0.0, TRAIN_RATE):
            o, lse = mha_forward(*args, rate=rate, seed=seed)
            do = torch.randn(o.shape, device="cuda").to(torch.bfloat16)
            bargs = (q, k, v, bias, seed, o, lse, do, heads, causal,
                     args[6], args[7], rate)
            want_o = mha_forward_plain(*args, rate, seed)[0]
            want_g = mha_backward_plain(*bargs)
            fwd_fns = (lambda: p_fwd(*args, rate=rate, seed=seed),
                       lambda: mha_forward(*args, rate=rate, seed=seed))
            bwd_fns = (lambda: p_bwd(*bargs), lambda: mha_backward(*bargs))
            row = {"phase": "head_dim_check", "case": "parent_wide_ab",
                   "shape": name, "rate": rate,
                   "order": "parent, change, change, parent"}
            for direction, fns in (("forward", fwd_fns),
                                   ("backward", bwd_fns)):
                t = [cuda_ms(fns[i], iters) for i in (0, 1, 1, 0)]
                row[direction] = {
                    "parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]],
                    "speedup": min(t[0], t[3]) / max(t[1], t[2])}
            row["forward"]["l2_err_o"] = {
                "parent": l2_err(fwd_fns[0]()[0], want_o),
                "change": l2_err(fwd_fns[1]()[0], want_o)}
            row["backward"]["l2_err_max"] = {
                who: max(l2_err(g, w) for g, w in zip(fn(), want_g))
                for who, fn in (("parent", bwd_fns[0]),
                                ("change", bwd_fns[1]))}
            row["ok"] = row["forward"]["speedup"] > 1 and \
                row["backward"]["speedup"] > 1
            emit(row)
            rows[(name, rate)] = row
            if not row["ok"]:
                raise AssertionError("the change is not faster than the "
                                     "parent's mha_wide.cu: %s" % row)
    return rows


def head_dim_phase(seed, parent_wide_source=None):
    """The attention kernels at other head dims than the flagship's: the
    flagship widths with 4 heads (D=128, 192), 768 wide with 16 heads
    (D=48 on the D=64 kernel, padded), 512 wide with 2 heads (D=256), bf16
    at the B=16 train shapes; the two other instantiations (D=160, 224) at
    small shapes; one fp32 case; above 256 the wide kernels at D=384, 512,
    768 (train shapes), 288, 320 and 1024 (small), one fp32 case, and
    which kernels the bf16 wide calls launch; above 1024 raises.  With
    ``parent_wide_source`` (a parent commit's csrc/mha_wide.cu), the A/B of
    the wide train shapes against it."""
    rng = np.random.RandomState(seed + 30)
    enc_len = rng.randint(96, 193, 16)
    for name, c, heads, shape in (
            ("train_encoder_h4", 512, 4, "encoder"),
            ("train_decoder_causal_h4", 768, 4, "decoder_causal"),
            ("train_cross_h4", 768, 4, "cross"),
            ("train_decoder_causal_d48", 768, 16, "decoder_causal"),
            ("train_cross_d48", 768, 16, "cross"),
            ("train_encoder_d256", 512, 2, "encoder"),
            ("train_decoder_causal_d256", 512, 2, "decoder_causal")):
        tq, tk, causal, lengths, cross = {
            "encoder": (192, 192, False, enc_len, False),
            "decoder_causal": (448, 448, True, None, False),
            "cross": (448, 192, False, enc_len, True)}[shape]
        check_train_attention(name, rng, 16, tq, tk, c, heads, causal,
                              lengths, 0, cross=cross)
    check_train_attention("small_causal_d160", rng, 4, 200, 200, 640, 4, True,
                          None, 0, iters=5)
    check_train_attention("small_cross_d224", rng, 4, 200, 77, 448, 2, False,
                          [77, 50, 1, 77], 0, cross=True, iters=5)
    check_train_attention("train_encoder_h4_fp32", rng, 16, 192, 192, 512, 4,
                          False, enc_len, 0, dtype=torch.float32, iters=5)
    # above 256, csrc/mha_wide.cu (run-time head dim): the flagship widths
    # with 2 heads (decoder D=384) and 1 (encoder D=512, decoder D=768) at
    # the B=16 train shapes; at small shapes D=288 (576 wide, 2 heads;
    # cross, and causal with Tq off the 64-row tiles), D=320 (640 wide, 2
    # heads: a 160-column slice and a half D chunk; one key tile) and
    # D=1024 (1 head, four slices); one fp32 case
    for name, c, heads, shape in WIDE_TRAIN_CASES:
        tq, tk, causal, lengths, cross = {
            "encoder": (192, 192, False, enc_len, False),
            "decoder_causal": (448, 448, True, None, False),
            "cross": (448, 192, False, enc_len, True)}[shape]
        check_train_attention(name, rng, 16, tq, tk, c, heads, causal,
                              lengths, 0, cross=cross, iters=5)
    check_train_attention("small_cross_d288", rng, 4, 200, 77, 576, 2, False,
                          [77, 50, 1, 77], 0, cross=True, iters=5)
    check_train_attention("small_causal_d288_t141", rng, 3, 141, 141, 576, 2,
                          True, None, 0, iters=5)
    check_train_attention("small_cross_d320_one_tile", rng, 4, 200, 50, 640,
                          2, False, [50, 31, 1, 50], 0, cross=True, iters=5)
    check_train_attention("small_causal_d1024", rng, 2, 150, 150, 1024, 1,
                          True, None, 0, iters=5)
    check_train_attention("small_causal_d384_fp32", rng, 4, 120, 120, 768, 2,
                          True, None, 0, dtype=torch.float32, iters=3)
    wide_kernels_check(rng)
    if parent_wide_source:
        parent_wide_ab(parent_wide(parent_wide_source), rng, enc_len)
    # above the largest head dim: a ValueError that names the limit
    d_over = MAX_HEAD_DIM + 32
    q = torch.zeros(1, 8, d_over, dtype=torch.bfloat16, device="cuda")
    try:
        mha_forward(q, q, q, None, 1, False, 1.0, False)
    except ValueError as e:
        refused = str(MAX_HEAD_DIM) in str(e)
        message = str(e)
    else:
        refused, message = False, None
    row = {"phase": "head_dim_check", "case": "head_dim_%d" % d_over,
           "raised_value_error_naming_the_limit": refused,
           "message": message,
           "instantiation_by_head_dim": {
               d: kernel_head_dim(d) for d in (8, 12, 32, 48, 80, 128, 192,
                                               200, 256, 288, 300, 384, 512,
                                               768, 1024)}}
    emit(row)
    if not refused:
        raise AssertionError("head dim %d did not raise: %s" % (d_over, row))


# ---------------------------------------------------------------------------
# phase 5: the fused decode step against its plain version
# ---------------------------------------------------------------------------

def decode_bound(w, x, cache_k, mem_k, heads, step):
    """Least time for one frame: the stacked weights, the memory K/V and
    bias, x and the valid cache prefix (t < step) read once, x_out, align
    and k/v_new written once; the products' operations at the weights'
    type's peak rate."""
    n_layers, b, _, c = cache_k.shape
    t_mem = mem_k.shape[2]
    elt = cache_k.element_size()
    params = sum(w[n].numel() for n in DECODE_WEIGHTS)
    nbytes = params * elt + w["lns"].numel() * 4 + \
        2 * mem_k.numel() * elt + b * t_mem * 4 + \
        2 * n_layers * b * step * c * elt + \
        2 * x.numel() * 4 + n_layers * b * t_mem * heads * 4 + \
        2 * n_layers * b * c * elt
    flops = 2.0 * b * params + 4.0 * n_layers * b * c * (step + 1 + t_mem)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS_PER_S[cache_k.dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations"), nbytes, flops


def decode_inputs(rng, w, b, t_cap, t_in, dtype):
    """x, caches, memory K/V (projected from a random encoder output by the
    stacked w_kv, padded to 256) and the padding bias of random lengths."""
    n_layers, c = w["w_qkv"].shape[0], w["w_qkv"].shape[1]
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
    enc = t(b, t_in, w["w_kv"].shape[1])
    mem_k, mem_v = project_memory(enc, w["w_kv"], dtype)
    lengths = rng.randint(t_in // 2, t_in + 1, b)
    lengths[0] = t_in
    bias = torch.from_numpy(np.where(
        np.arange(mem_k.shape[2])[None, :] < lengths[:, None], 0.0,
        -1e20).astype(np.float32)).cuda()
    return (t(b, c), t(n_layers, b, t_cap, c).to(dtype),
            t(n_layers, b, t_cap, c).to(dtype), mem_k, mem_v, bias)


def stage_breakdown(w, inputs, heads, step, reps=5, fn=None):
    """Microseconds per stage kind, summed over the layers and averaged over
    ``reps`` frames, from the kernel's timeline (block 0's global-timer
    stamps at each grid-wide barrier); ``fn`` another kernel with the same
    timeline (the parent's), by default decoder_frame_step."""
    x, ck, cv, mk, mv, bias = inputs
    n_layers = ck.shape[0]
    trace = torch.zeros(len(STAGES) * n_layers + 2, dtype=torch.int64,
                        device="cuda")
    total = np.zeros(1 + len(STAGES))
    for _ in range(reps):
        (fn or decoder_frame_step)(x, step, w, ck, cv, mk, mv, bias,
                                   num_heads=heads, trace=trace)
        d = np.diff(trace.cpu().numpy().astype(np.float64)) / 1e3
        total += np.concatenate([d[:1], d[1:].reshape(n_layers, -1).sum(0)])
    total /= reps
    return dict(zip(("stage0",) + STAGES, total.tolist()),
                total=float(total.sum()))


def l2_err(got, want):
    return ((got.float() - want.float()).norm() /
            want.float().norm()).item()


def align_errors(got, want, bias):
    """The align readings of TOL_DECODE for [L, B, Tm, H] weights: the
    largest row L1 distance, the largest error over its row's largest
    weight, the largest weight either puts on a padded column, and the
    largest |row sum - 1| of either."""
    d = (got - want).abs()
    pad = (bias < -1e19)[None, :, :, None].expand_as(got)
    both = torch.stack([got, want])
    return {"align_l1": d.sum(2).max().item(),
            "align_row": (d.amax(2) / want.amax(2)).max().item(),
            "align_max_abs_err": d.max().item(),
            "align_pad_max": both[:, pad].abs().max().item()
            if bool(pad.any()) else 0.0,
            "align_row_sum_err": (both.sum(3) - 1).abs().max().item()}


@torch.no_grad()
def decode_plain_f64(x, step, w, cache_k, cache_v, mem_k, mem_v, mem_bias, *,
                     num_heads):
    """decoder_frame_step_plain's math at its rounding points (float32
    values where it holds float32: the residual stream, and every value it
    rounds to float32 before a bf16 rounding), with every sum in float64: the reference of a case whose sums run over so many
    positions that the plain version's own float32 sums carry a bf16
    rounding to the other side (the long cache)."""
    n_layers, b, _, c = cache_k.shape
    h, wdt, cdt = num_heads, w["w_qkv"].dtype, cache_k.dtype
    d = c // h
    scale = float(d) ** -0.5
    f32 = lambda t: t.float().double()              # rounded to float32
    rnd = lambda t: t.float().to(wdt).double()      # ... then to bf16
    mm = lambda a, wt: torch.matmul(rnd(a), wt.double())
    heads = lambda t: t.reshape(*t.shape[:-1], h, d)

    def ln(t, g, bt):
        m = t.mean(-1, keepdim=True)
        tc = t - m
        return tc * (1.0 / torch.sqrt((tc * tc).mean(-1, keepdim=True) +
                                      1e-6)) * g + bt
    x = x.double()
    aligns, k_new, v_new = [], [], []
    for l in range(n_layers):
        lns = w["lns"][l].double()
        qkv = f32(mm(ln(x, lns[0], lns[1]), w["w_qkv"][l]))
        q = f32(qkv[:, :c] * scale)
        k_f, v_f = qkv[:, c:2 * c], qkv[:, 2 * c:]
        k_new.append(k_f.to(cdt))
        v_new.append(v_f.to(cdt))
        fresh = rnd(f32(heads(q * k_f))).sum(-1)
        s = rnd(heads(rnd(q))[:, None] *
                heads(cache_k[l, :, :step].double())).sum(-1)
        m = torch.maximum(s.amax(1), fresh) if step else fresh
        p = torch.exp(s - m[:, None])
        pf = torch.exp(fresh - m)
        den = p.sum(1) + pf
        ctx = (rnd(p / den[:, None])[..., None] *
               heads(cache_v[l, :, :step].double())).sum(1) + \
            rnd(pf / den)[..., None] * heads(v_f)
        x = f32(x + f32(mm(ctx.reshape(b, c), w["w_out"][l])))
        qx = f32(f32(mm(ln(x, lns[2], lns[3]), w["w_q"][l])) * scale)
        s = rnd(heads(rnd(qx))[:, None] * heads(mem_k[l].double())).sum(-1) \
            + mem_bias.double()[..., None]
        p = torch.exp(s - s.amax(1, keepdim=True))
        wts = p / p.sum(1, keepdim=True)
        aligns.append(wts)
        ctx = (rnd(wts)[..., None] * heads(mem_v[l].double())).sum(1)
        x = f32(x + f32(mm(ctx.reshape(b, c), w["w_xout"][l])))
        hid = torch.relu(mm(ln(x, lns[4], lns[5]), w["w_ffn1"][l]))
        x = f32(x + f32(mm(hid, w["w_ffn2"][l])))
    return (x.float(), torch.stack(aligns).float(), torch.stack(k_new),
            torch.stack(v_new))


def check_decode(name, w, inputs, heads, step, iters=20, tol_key=None,
                 stages=True, reference=decoder_frame_step_plain):
    """The kernel against ``reference`` (its plain version unless stated),
    held to TOL_DECODE[tol_key] (the case's name by default); three
    launches must give the same bits."""
    x, ck, cv, mk, mv, bias = inputs
    args = (x, step, w, ck, cv, mk, mv, bias)
    got = decoder_frame_step(*args, num_heads=heads)
    again = [decoder_frame_step(*args, num_heads=heads) for _ in range(2)]
    want = reference(*args, num_heads=heads)
    torch.cuda.synchronize()
    tol = TOL_DECODE[tol_key or name]
    outs = ("x_out", "k_new", "v_new")
    pairs = list(zip(outs, (got[0], got[2], got[3]),
                     (want[0], want[2], want[3])))
    errs = {"rel_err_" + n: rel_err(g, wt) for n, g, wt in pairs}
    l2 = {"l2_err_" + n: l2_err(g, wt) for n, g, wt in pairs}
    al = align_errors(got[1], want[1], bias)
    bound_ms, bound_by, nbytes, flops = decode_bound(w, x, ck, mk, heads,
                                                     step)
    plain_vs_ref = None
    if reference is not decoder_frame_step_plain:
        plain_vs_ref = l2_err(decoder_frame_step_plain(*args,
                                                       num_heads=heads)[0],
                              want[0])
    row = {"phase": "decode_kernel_check", "case": name,
           "reference": reference.__name__,
           "plain_l2_err_x_out_vs_reference": plain_vs_ref,
           "dtype": str(ck.dtype), "L": ck.shape[0], "B": x.shape[0],
           "C": x.shape[1], "H": heads, "Tcap": ck.shape[2],
           "Tm": mk.shape[2], "step": step, **errs, **l2, **al,
           "max_abs_err": abs_err(got[0], want[0]),
           "max_abs_x_out": want[0].abs().max().item(),
           "repeat_bit_identical": all(torch.equal(a, b) for rep in again
                                       for a, b in zip(got, rep)),
           "tol": tol, "tol_row_sum": TOL_ROW_SUM,
           "ms": cuda_ms(lambda: decoder_frame_step(*args, num_heads=heads),
                         iters),
           "plain_ms": cuda_ms(lambda: decoder_frame_step_plain(
               *args, num_heads=heads), 2),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "flops": flops,
           "stage_us": stage_breakdown(w, inputs, heads, step)
           if stages else None}
    row["ok"] = max(errs.values()) <= tol["rel"] and \
        max(l2.values()) <= tol["l2"] and \
        al["align_l1"] <= tol["l1"] and al["align_row"] <= tol["row"] and \
        al["align_pad_max"] == 0.0 and \
        al["align_row_sum_err"] <= TOL_ROW_SUM and \
        row["repeat_bit_identical"] and \
        all(bool(torch.isfinite(g).all()) for g in got)
    emit(row)
    if not row["ok"]:
        raise AssertionError("decoder_frame_step disagrees with its plain "
                             "version at %s: %s" % (name, row))
    return row


def wrapper_host_us(w, inputs, heads, step, n=50):
    """Host microseconds per ``decoder_frame_step`` call, per call with
    ``out`` (the frame loop's: no checks, no allocations), and of its
    argument checks alone, while a sleep kernel holds the card (so no call
    waits on the device)."""
    x, ck, cv, mk, mv, bias = inputs
    args = (x, step, w, ck, cv, mk, mv, bias)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    tic = time.perf_counter()
    for _ in range(n):
        decoder_frame_step(*args, num_heads=heads)
    call = (time.perf_counter() - tic) / n * 1e6
    out = decode_ops.FrameStepOut(x, w, ck, cv, mk, mv, bias,
                                  num_heads=heads)
    tic = time.perf_counter()
    for _ in range(n):
        decoder_frame_step(*args, num_heads=heads, out=out)
    call_out = (time.perf_counter() - tic) / n * 1e6
    tic = time.perf_counter()
    for _ in range(n):
        decode_ops._check(*args, heads)
        decode_ops._check_cuda(x, w, ck, cv, mk, mv, bias, heads)
    checks = (time.perf_counter() - tic) / n * 1e6
    torch.cuda.synchronize()
    return {"call_us": call, "call_with_out_us": call_out,
            "checks_us": checks}


@torch.no_grad()
def eager_step_ms(model, hp, batch, step=255, cap=512):
    """Device time of one eager ``decode_step`` frame (the per-layer path
    the fused step replaces), for context."""
    inputs, lengths, spk, lvec = (torch.from_numpy(a).cuda() for a in
                                  prepare_decode_inputs(batch, hp))
    with matmul_weights_in(model, model.dtype):
        _, memory_kv = model.encode(inputs, lengths, spk, lvec)
        bias = padding_bias(length_mask(lengths, inputs.shape[1]))
        cache = model.init_decode_cache(inputs.shape[0], cap)
        prev = torch.zeros(inputs.shape[0], hp.num_mels, device="cuda")
        # two frames: ~1000 launches stay within the launch queue, so the
        # sleep kernel still covers the host's queuing
        return cuda_ms(lambda: model.decode_step(prev, step, cache,
                                                 memory_kv, bias), 2)


def barriers_per_frame(w, inputs, heads, step):
    """Grid barriers one launch passes: the kernel's barrier count (block
    arrivals) before and after it, over the grid (one block per SM)."""
    x, ck, cv, mk, mv, bias = inputs
    state = decode_ops.barrier_state(
        x.device, torch.cuda.current_stream().cuda_stream)
    grid = torch.cuda.get_device_properties(x.device).multi_processor_count
    torch.cuda.synchronize()
    before = int(state.item())
    decoder_frame_step(x, step, w, ck, cv, mk, mv, bias, num_heads=heads)
    torch.cuda.synchronize()
    return (int(state.item()) - before) / grid


def parent_decoder(source):
    """The parent commit's decoder_step.cu, built here (its C interface:
    the six stacked weights, fixed-point scratch), as a function of
    decoder_frame_step's arguments: for the A/B of one call."""
    import ctypes
    out = os.path.join(ROOT, "build", "parent_decoder", "libdecoder_step.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    out, source], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decoder_step.argtypes = [i, p, i] + [p] * 18 + [i] * 7 + [p]
    lib.decoder_step.restype = i
    lib.decoder_step_scratch_bytes.argtypes = [i, i, i]
    lib.decoder_step_scratch_bytes.restype = ctypes.c_longlong

    def step_fn(x, step, w, ck, cv, mk, mv, bias, num_heads, trace=None):
        n_layers, b, t_cap, c = ck.shape
        f = w["w_ffn1"].shape[-1]
        x_out = torch.empty(b, c, device="cuda")
        align = torch.empty(n_layers, b, mk.shape[2], num_heads,
                            device="cuda")
        k_new = torch.empty(n_layers, b, c, dtype=ck.dtype, device="cuda")
        v_new = torch.empty_like(k_new)
        scratch = torch.empty(lib.decoder_step_scratch_bytes(b, c, f),
                              dtype=torch.uint8, device="cuda")
        err = lib.decoder_step(
            1 if ck.dtype == torch.bfloat16 else 0, x.data_ptr(), step,
            w["lns"].data_ptr(), *(w[n].data_ptr() for n in DECODE_WEIGHTS),
            ck.data_ptr(), cv.data_ptr(), mk.data_ptr(), mv.data_ptr(),
            bias.data_ptr(), x_out.data_ptr(), align.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), scratch.data_ptr(),
            None if trace is None else trace.data_ptr(),
            n_layers, b, t_cap, mk.shape[2], c, f, num_heads,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("the parent's decoder_step failed: %d" % err)
        return x_out, align, k_new, v_new
    return step_fn


def parent_ab(parent, w, inputs, heads, iters=20):
    """ms per frame of the parent's kernel and this one at steps 0, 256 and
    511, in the order parent, change, change, parent, with the parent's
    x_out against the plain version's."""
    x, ck, cv, mk, mv, bias = inputs
    rows = {}
    for step in (0, 256, 511):
        args = (x, step, w, ck, cv, mk, mv, bias)
        want = decoder_frame_step_plain(*args, num_heads=heads)[0]
        old = parent(*args, num_heads=heads)[0]
        times = []
        for fn in (parent, decoder_frame_step, decoder_frame_step, parent):
            times.append(cuda_ms(lambda: fn(*args, num_heads=heads), iters))
        rows[step] = {"parent_ms": [times[0], times[3]],
                      "change_ms": [times[1], times[2]],
                      "parent_rel_err_x_out": rel_err(old, want),
                      "parent_stage_us": stage_breakdown(w, inputs, heads,
                                                         step, fn=parent),
                      "change_stage_us": stage_breakdown(w, inputs, heads,
                                                         step)}
    emit({"phase": "decode_kernel_check", "case": "parent_ab",
          "order": "parent, change, change, parent", "by_step": rows})
    return rows


def decode_kernel_phase(model, hp, batch, seed, parent_source=None):
    rng = np.random.RandomState(seed + 20)
    heads = hp.n_attention_head
    rows = {}
    w = stack_decoder_params(model.decoder.decoder, torch.bfloat16)
    inputs = decode_inputs(rng, w, 8, 512, 192, torch.bfloat16)
    for step in (0, 1, 255, 256, 511):
        rows[step] = check_decode("flagship_bf16", w, inputs, heads, step)
    rows["barriers_per_frame"] = barriers_per_frame(w, inputs, heads, 256)
    emit({"phase": "decode_kernel_check", "case": "barriers",
          "L": w["w_qkv"].shape[0],
          "barriers_per_frame": rows["barriers_per_frame"]})
    rows["host"] = wrapper_host_us(w, inputs, heads, 256)
    emit({"phase": "decode_kernel_check", "case": "wrapper_host_time",
          "step": 256, **rows["host"]})
    if parent_source:
        rows["parent_ab"] = parent_ab(parent_decoder(parent_source), w,
                                      inputs, heads)
    # the same weights as 2 heads of 384: the flagship width at D=384
    rows["d384"] = check_decode("flagship_d384_bf16", w, inputs, 2, 300,
                                iters=5, tol_key="flagship_bf16")
    # the first layer alone at the same width: one layer of drift
    w1 = {k: v[:1].contiguous() for k, v in w.items()}
    first = lambda t: t[:1].contiguous() if t.dim() == 4 else t
    check_decode("one_layer_bf16", w1, tuple(first(t) for t in inputs),
                 heads, 300, iters=5)
    # a cache past 16384 positions: the first layer, 2 rows
    long_inputs = decode_inputs(rng, w1, 2, 16640, 192, torch.bfloat16)
    # over 16,500 positions the plain version's float32 sums themselves
    # carry bf16 roundings across, so this case is held to the same math in
    # float64 (the row reports how far the plain version lies from it)
    rows["long_cache"] = check_decode(
        "long_cache_one_layer_bf16", w1, long_inputs, heads, 16500, iters=5,
        tol_key="one_layer_bf16", stages=False, reference=decode_plain_f64)
    del long_inputs
    w32 = stack_decoder_params(model.decoder.decoder, torch.float32)
    check_decode("flagship_fp32", w32,
                 decode_inputs(rng, w32, 8, 512, 192, torch.float32), heads,
                 300, iters=5)
    # small widths: C=128, 4 heads (D=32), 2 layers, 3 rows
    small = {"lns": torch.from_numpy(np.stack(
        [1 + 0.1 * rng.randn(2, 128) if i % 2 == 0 else
         0.1 * rng.randn(2, 128) for i in range(6)], 1).astype(
            np.float32)).cuda()}
    for name, (k, n) in {"w_qkv": (128, 384), "w_out": (128, 128),
                         "w_q": (128, 128), "w_kv": (128, 256),
                         "w_xout": (128, 128), "w_ffn1": (128, 512),
                         "w_ffn2": (512, 128)}.items():
        small[name] = torch.from_numpy(
            (rng.randn(2, k, n) / np.sqrt(k)).astype(np.float32)).to(
                "cuda", torch.bfloat16)
    small["tiles"] = decode_ops.pack_decoder_weights(small)
    check_decode("small_c128_bf16", small,
                 decode_inputs(rng, small, 3, 256, 77, torch.bfloat16), 4,
                 100, iters=5)
    # 20 rows: the products run in three passes of 8 rows.  Over 20 rows
    # an fp32 sum of either version (the LayerNorm's, the plain version's
    # products) lands a bf16 rounding on the other side in some row, as
    # in the six-layer case, so it takes that case's bound; a pass that
    # computed the wrong rows would miss it by orders of magnitude
    check_decode("small_c128_b20_bf16", small,
                 decode_inputs(rng, small, 20, 256, 77, torch.bfloat16), 4,
                 100, iters=5, tol_key="flagship_bf16")
    eager = eager_step_ms(model, hp, batch)
    emit({"phase": "decode_kernel_check", "case": "eager_decode_step",
          "step": 255, "device_ms_per_frame": eager,
          "fused_ms_per_frame": rows[255]["ms"]})
    rows["eager_ms"] = eager
    return rows


# ---------------------------------------------------------------------------
# phase 6: the main path
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


KERNELS = {"mha_forward": mha_forward, "mha_backward": mha_backward,
           "layer_norm_backward": layer_norm_backward,
           "decoder_frame_step": decoder_frame_step,
           "fused_frame_mel": fused_frame_mel, "fused_adam_step": adam_leaves}
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def timed_synthesis(model, hp, batch, frames):
    """One counted synthesize_batch call after a short warm-up: (output,
    wall seconds, kernel launches of the call)."""
    synthesize_batch(model, batch, hp, deterministic=True,
                     collect_alignments=False, max_frames=8)
    torch.cuda.synchronize()
    reset_counts()
    tic = time.perf_counter()
    out = synthesize_batch(model, batch, hp, deterministic=True,
                           collect_alignments=False, max_frames=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    return out, wall, read_counts()


def check_mels(out, frames, hp):
    mel = out["mel_aft"]
    if mel.shape != (8, frames, hp.num_mels) or \
            not np.isfinite(mel).all() or \
            not np.isfinite(out["mel_pre"]).all():
        raise AssertionError("bad synthesis output: shape %s, finite %s"
                             % (mel.shape, np.isfinite(mel).all()))


def main_path_phase(model, hp, batch, seed):
    plain = ByteToMel(hp.replace(use_pallas_attention=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain.eval()
    frames = 512
    out, wall, counts = timed_synthesis(model, hp, batch, frames)
    launches = counts["mha_forward"]
    if counts != dict(NO_LAUNCHES, mha_forward=hp.n_encoder_layer):
        raise AssertionError("main path launched the kernels %s times, "
                             "expected %d forward calls and no other"
                             % (counts, hp.n_encoder_layer))
    check_mels(out, frames, hp)
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
           "kernel_launches": launches, "launches_by_kernel": counts,
           "wall_s": wall,
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
    profile_phase(model, hp, batch, "profile")
    return counts, out


def main_path_fused_phase(model, hp, batch):
    """synthesize_batch through the fused decode step: one
    decoder_frame_step launch per frame, its first frames against the eager
    path, frames/s and a profile window."""
    hp_fused = hp.replace(use_pallas_decode=True)
    frames = 512
    out, wall, counts = timed_synthesis(model, hp_fused, batch, frames)
    check_mels(out, frames, hp)
    want = dict(NO_LAUNCHES, mha_forward=hp.n_encoder_layer,
                decoder_frame_step=frames)
    # the fused path is deterministic: the same call gives the same bits
    again = synthesize_batch(model, batch, hp_fused, deterministic=True,
                             collect_alignments=False, max_frames=frames)
    repeat = {"mel_pre_max_abs_diff": float(np.abs(
                  again["mel_pre"] - out["mel_pre"]).max()),
              "mel_aft_max_abs_diff": float(np.abs(
                  again["mel_aft"] - out["mel_aft"]).max()),
              "lengths_equal": again["generated_lengths"] ==
              out["generated_lengths"]}
    out_e = synthesize_batch(model, batch, hp, deterministic=True,
                             collect_alignments=False, max_frames=32)
    frame_err = float(np.abs(out["mel_pre"][:, :32] -
                             out_e["mel_pre"]).max())
    n_frames = int(np.sum(out["generated_lengths"]))
    row = {"phase": "main_path_fused", "config": "default_config (flagship)",
           "B": 8, "T_in": 192, "max_frames": frames,
           "launches_by_kernel": counts, "wall_s": wall, "frames": n_frames,
           "frames_per_s": n_frames / wall, "rtf": wall / n_frames * 80,
           "first32_max_abs_err_vs_eager": frame_err,
           "tol_frames": TOL_FRAMES, "repeat": repeat,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    if counts != want or frame_err > TOL_FRAMES or \
            not repeat["lengths_equal"] or \
            repeat["mel_pre_max_abs_diff"] != 0.0 or \
            repeat["mel_aft_max_abs_diff"] != 0.0:
        raise AssertionError("fused synthesis failed (launches expected %s): "
                             "%s" % (want, row))
    profile_phase(model, hp_fused, batch, "profile_fused")
    frame_graph_phase(model, hp)
    return counts


# the fused frame loop's shapes: (name, config overrides, rows, text bytes,
# cap of the bit check, cap of the timing)
GRAPH_SHAPES = (("flagship.synth", {}, 32, 160, 45, 896),
                ("ljspeech.utt", dict(multi_speaker=False,
                                      multi_lingual=False,
                                      decoder_hidden=512), 1, 60, 125, 517))


@torch.no_grad()
def fused_frames(model, hp, batch, cap, collect):
    """synthesize's per-call state of the fused loop (call inside
    ``matmul_weights_in``)."""
    args = [torch.from_numpy(a).cuda()
            for a in prepare_decode_inputs(batch, hp)]
    bias = padding_bias(length_mask(args[1], args[0].shape[1]))
    return _FusedFrames(model, args, bias, cap, collect)


@torch.no_grad()
def graph_bit_check(model, hp, batch, cap):
    """``_fused_loop`` (frame 0's chain eager, then the CUDA graph of it)
    against the same frames with every chain run eagerly on the card,
    alignments on: whether every buffer holds the same bits, and the
    largest difference of each."""
    with matmul_weights_in(model, model.dtype):
        graphed = fused_frames(model, hp, batch, cap, True)
        steps = _fused_loop(graphed, cap)
        eager = fused_frames(model, hp, batch, cap, True)
        for step in range(steps):
            eager.chain(eager.launch(step))
    torch.cuda.synchronize()
    fields = ("mels", "target_lengths", "finished", "prev_mel", "cache_k",
              "cache_v", "aligns", "x", "step_t")
    diff = {f: float((getattr(graphed, f).double() -
                      getattr(eager, f).double()).abs().max())
            for f in fields}
    return {"frames": steps, "cap": cap,
            "bit_identical": all(torch.equal(getattr(graphed, f),
                                             getattr(eager, f))
                                 for f in fields),
            "max_abs_diff": diff}


@torch.no_grad()
def frame_loop_timing(model, hp, batch, cap, graphed):
    """One fused loop to ``cap`` (every row runs to it), its chains replayed
    from the graph or run eagerly: wall s, frames/s (real rows x frames), host
    us a frame in the ``synth.frame`` span, capture ms, stop-check ms."""
    with matmul_weights_in(model, model.dtype):
        fr = fused_frames(model, hp, batch, cap, False)
        torch.cuda.synchronize()
        tracing.reset()
        tic = time.perf_counter()
        if graphed:
            steps = _fused_loop(fr, cap)
        else:
            steps = 0
            for step in _steps(cap, fr.finished):
                with tracing.span("synth.frame"):
                    fr.chain(fr.launch(step))
                steps = step + 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    spans = tracing.windows()[-1]["spans"]
    get = lambda name: spans.get(name, (0, 0.0, 0.0))
    return {"frames": steps, "wall_s": wall,
            "frames_per_s": steps * len(batch["inputs"]) / wall,
            "frame_steps_per_s": steps / wall,
            "host_us_per_frame": get("synth.frame")[1] / steps * 1e6,
            "capture_ms": get("synth.capture")[1] * 1e3,
            "stop_check_ms": get("synth.stop_check")[1] * 1e3}


def frame_graph_phase(model, hp, seed=5):
    """The fused frame loop's CUDA graph at the benchmark's two decode
    shapes (flagship B=32 and ljspeech B=1 padded to 8): graphed frames
    against the eager chain bit for bit at a cap that is not a multiple of
    16, then host us a frame, capture ms and frames/s, graphed and eager
    (the second of two runs each)."""
    for name, overrides, rows, t_in, check_cap, cap in GRAPH_SHAPES:
        shape_hp = hp.replace(**overrides)
        shape_model = model if not overrides else \
            flagship_model(shape_hp, seed, "cuda")
        rng = np.random.RandomState(seed)
        shape_batch = {
            "inputs": rng.randint(3, 255, (rows, t_in)).astype(np.int32),
            "input_lengths": rng.randint(t_in // 2, t_in + 1,
                                         rows).astype(np.int32)}
        if shape_hp.multi_speaker:
            shape_batch["input_spk_ids"] = rng.randint(
                0, shape_hp.max_num_speaker, rows).astype(np.int32)
            shape_batch["input_language_vecs"] = np.eye(
                shape_hp.max_num_language, dtype=np.float32)[
                rng.randint(0, shape_hp.max_num_language, rows)]
        check = graph_bit_check(shape_model, shape_hp, shape_batch,
                                check_cap)
        allocated = torch.cuda.memory_allocated()
        timing = {}
        for graphed in (True, False, True, False):
            timing["graphed" if graphed else "eager_chain"] = \
                frame_loop_timing(shape_model, shape_hp, shape_batch, cap,
                                  graphed)
        row = {"phase": "main_path_fused_graph", "shape": name,
               "B": rows, "B_padded": prepare_decode_inputs(
                   shape_batch, shape_hp)[0].shape[0],
               "T_in": t_in, "bit_check": check, **timing,
               # a stream of its own a call would hold a cuBLAS workspace
               # each: the four loops must leave no allocation behind
               "allocated_growth_mb": (torch.cuda.memory_allocated() -
                                       allocated) / 2 ** 20,
               "speedup_frames_per_s":
               timing["graphed"]["frames_per_s"] /
               timing["eager_chain"]["frames_per_s"]}
        emit(row)
        if not check["bit_identical"]:
            raise AssertionError("graphed frames differ from the eager "
                                 "chain: %s" % row)
        del shape_model


def device_kernels(prof):
    """(device kernels by name, annotation ranges): the ranges that annotate
    host code on the device timeline (``Optimizer.step#...``) span kernels
    that are listed too, so they stay out of the busy time."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    # kernel names are demangled C++ ("{lambda()#3}"): a range has a "#"
    # and no "::"
    is_range = lambda e: getattr(e, "is_user_annotation", False) or \
        ("#" in e.key and "::" not in e.key)
    return ([e for e in events if not is_range(e)],
            [e for e in events if is_range(e)])


def top_events(events, n):
    return [{"name": e.key[:80], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in sorted(events,
                            key=lambda e: -e.self_device_time_total)[:n]]


def profile_phase(model, hp, batch, phase, frames=64):
    """Where a short synthesis call spends its time: device busy time (sum
    of CUDA kernel times from torch.profiler) against the unprofiled wall
    time of the same call, kernel launches per frame, and the top kernels."""
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
    kernels, ranges = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    emit({"phase": phase, "frames": frames, "B": 8,
          "wall_ms_unprofiled": wall_ms,
          "device_busy_ms": busy_ms if kernels else None,
          "device_idle_share": 1 - busy_ms / wall_ms if kernels else None,
          "kernel_launches": launches,
          "launches_per_frame": launches / frames,
          "top_kernels": top_events(kernels, 6),
          "annotation_ranges_excluded": top_events(ranges, 6)})


# ---------------------------------------------------------------------------
# phase 8: the CLI
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
    # the eager frame loop, then the fused decode step
    for phase, hparams, sub in (
            ("cli", "max_generation_frames=64", "synth"),
            ("cli_fused", "max_generation_frames=64,use_pallas_decode=True",
             "synth_fused")):
        wav_dir = os.path.join(out_dir, sub)
        reset_counts()
        tic = time.perf_counter()
        cli.main(["--checkpoint", ckpt, "--script",
                  os.path.join(out_dir, "script.txt"), "--data-dir", out_dir,
                  "--output-dir", wav_dir, "--deterministic",
                  "--hparams", hparams])
        wall = time.perf_counter() - tic
        counts = read_counts()
        files = sorted(os.listdir(wav_dir))
        for name in ("spk0_0", "spk1_0"):
            for ext in (".npy", ".wav"):
                if name + ext not in files:
                    raise AssertionError("CLI did not write %s%s: %s"
                                         % (name, ext, files))
        mel = np.load(os.path.join(wav_dir, "spk0_0.npy"))
        if mel.shape != (64, 80) or not np.isfinite(mel).all():
            raise AssertionError("CLI mel has shape %s" % (mel.shape,))
        emit({"phase": phase, "wall_s": wall, "files": files,
              "kernel_launches": counts["mha_forward"],
              "launches_by_kernel": counts})
        fused_launches = counts["decoder_frame_step"]
        if (phase == "cli_fused") != (fused_launches > 0):
            raise AssertionError("%s launched decoder_frame_step %d times"
                                 % (phase, fused_launches))
    os.remove(ckpt)


# ---------------------------------------------------------------------------
# phase 8a: the eval service over the three checkpoint formats
# ---------------------------------------------------------------------------

EVAL_HPARAMS = "max_generation_frames=256,max_eval_batches=2," \
    "batch_frame_limit=1600"     # 8 utterances of 200 frames a batch
EVAL_LANGS = ("en-us", "de-de")


def write_eval_corpus(root, seed, num_mels=80, per_lang=8, frames=200):
    """mels.zip, metadata.eval.txt and the id maps: 2 languages x 8
    utterances of ``frames`` mel frames and 60-180 bytes of text."""
    import io
    import zipfile
    rng = np.random.RandomState(seed + 7)
    rows, names = [], []
    words = ["alpha", "bravo", "delta", "echo", "golf", "hotel", "lima",
             "oscar", "tango", "victor"]
    with zipfile.ZipFile(os.path.join(root, "mels.zip"), "w") as zf:
        for lang in EVAL_LANGS:
            for i in range(per_lang):
                name = "%s0_%010d" % (lang[:2], i)
                text = ""
                target = int(rng.randint(60, 181))
                while len(text) < target:
                    text += words[rng.randint(len(words))] + " "
                buf = io.BytesIO()
                np.save(buf, np.clip(rng.randn(frames, num_mels), -4,
                                     4).astype(np.float32))
                zf.writestr(name + ".npy", buf.getvalue())
                rows.append("%s.npy|%d|%s|%s" % (name, frames,
                                                 text[:target].strip(), lang))
                names.append(name)
    with open(os.path.join(root, "metadata.eval.txt"), "w") as f:
        f.write("\n".join(rows))
    with open(os.path.join(root, "lang_id.json"), "w") as f:
        json.dump({lang: i for i, lang in enumerate(EVAL_LANGS)}, f)
    with open(os.path.join(root, "spk_id.json"), "w") as f:
        json.dump({lang[:2] + "0": i for i, lang in enumerate(EVAL_LANGS)},
                  f)
    return names


def jax_train_state(model, step):
    """The model as the JAX package's train state, in its checkpoints'
    layout: {step, params, opt_state: ({count, mu, nu}, {count}),
    batch_stats}, with zero Adam moments."""
    variables = jax_variables_from_state_dict(model.state_dict())

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}
    count = np.asarray(step, np.int32)
    return {"step": count, "params": variables["params"],
            "opt_state": {"0": {"count": count,
                                "mu": zeros(variables["params"]),
                                "nu": zeros(variables["params"])},
                          "1": {"count": count}},
            "batch_stats": variables["batch_stats"]}


def write_sharded(tree, ckpt_dir, step, world=2):
    """``tree`` in the JAX package's sharded layout
    (``shard-<rank>-of-<world>.pkl``, leaves keyed by their '/' path, each
    with its slice indices): leaves alternate between the ranks and the
    largest is split by rows across them."""
    import pickle
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(tree, "")
    keys = sorted(flat)
    big = max(keys, key=lambda k: flat[k].size)
    os.makedirs(ckpt_dir, exist_ok=True)
    for rank in range(world):
        leaves = {}
        for key in keys[rank::world]:
            arr = flat[key]
            leaves[key] = {"shape": arr.shape, "dtype": str(arr.dtype),
                           "shards": [(tuple(slice(None) for _ in
                                             arr.shape), arr)]}
        arr = flat[big]
        rows = np.array_split(np.arange(arr.shape[0]), world)[rank]
        index = (slice(int(rows[0]), int(rows[-1]) + 1),) + \
            tuple(slice(None) for _ in arr.shape[1:])
        leaves[big] = {"shape": arr.shape, "dtype": str(arr.dtype),
                       "shards": [(index, arr[index])]}
        with open(os.path.join(ckpt_dir, "shard-%d-of-%d.pkl"
                               % (rank, world)), "wb") as f:
            pickle.dump({"rank": rank, "world": world, "step": step,
                         "leaves": leaves}, f, protocol=4)


def eval_service_phase(model, hp, batch, out_dir, seed, smi):
    """The eval service CLI (``python -m few_shot_transformer_tts_torch.eval``,
    in-process) at the flagship width over one model dir holding the same
    random weights three times: a torch file at step 10000, a JAX msgpack
    file at 20000 and a two-rank sharded .d dir at 30000, on a synthetic
    corpus of 16 utterances over 2 languages.  Each format must load the
    source's state dict bit for bit; every sample gets .npy, .wav and
    _trim.wav; metrics.jsonl a finite mse_dtw per language and step; 6
    mha_forward launches per synthesize_batch; a spawn saver pool.  Step
    10000 runs with --gpu_vocoder."""
    import shutil
    from multiprocessing.reduction import ForkingPickler
    from few_shot_transformer_tts_torch import eval as eval_cli
    from few_shot_transformer_tts_torch.infer import save_eval_results
    tic_phase = time.perf_counter()
    root = os.path.join(out_dir, "eval_service")
    shutil.rmtree(root, ignore_errors=True)
    models = os.path.join(root, "models")
    os.makedirs(models)
    names = write_eval_corpus(root, seed, hp.num_mels)

    source = {k: v.detach().cpu().clone() for k, v in
              model.state_dict().items()}
    write_s = {}
    tic = time.perf_counter()
    optimizer, scheduler = make_optimizer(model, hp)
    save_state(models, model, optimizer, scheduler, 10000)
    write_s["torch"] = time.perf_counter() - tic
    tic = time.perf_counter()
    with open(os.path.join(models, "model.ckpt-20000"), "wb") as f:
        f.write(flax_msgpack.dumps(jax_train_state(model, 20000)))
    write_s["msgpack"] = time.perf_counter() - tic
    tic = time.perf_counter()
    write_sharded(jax_train_state(model, 30000),
                  os.path.join(models, "model.ckpt-30000.d"), 30000)
    write_s["sharded"] = time.perf_counter() - tic
    identical = {}
    for step, name in ((10000, "model.ckpt-10000"),
                       (20000, "model.ckpt-20000"),
                       (30000, "model.ckpt-30000.d")):
        fresh = ByteToMel(hp, device="cuda")
        path = os.path.join(models, name)
        loaded_step = load_state(path, fresh)
        got = fresh.state_dict()
        identical[checkpoint_format(path)] = loaded_step == step and \
            sorted(got) == sorted(source) and \
            all(torch.equal(got[k].cpu(), source[k]) for k in source)
        del fresh

    # what one batch's results cost to pickle for the pool: B=8, T_in=192,
    # 512 frames, encdec alignments of every layer and head
    out = synthesize_batch(model, batch, hp, deterministic=False,
                           max_frames=512)
    out["mel_pre"] = None
    out["alignments"]["self"] = None
    job = functools.partial(save_eval_results, **out, output_dir=root, hp=hp,
                            save_trimmed_wave=True)
    tic = time.perf_counter()
    payload = ForkingPickler.dumps(job)
    pickle_s = time.perf_counter() - tic
    align_bytes = sum(a.nbytes for a in out["alignments"]["encdec"])
    del out, job

    logs = os.path.join(root, "logs")
    argv = ["--model-dir", models, "--log-dir", logs, "--data-dir", root,
            "--no_wait", "--start_step", "0", "--eval_interval", "10000",
            "--hparams", EVAL_HPARAMS]
    log = open(os.path.join(root, "eval_cli.log"), "w")
    reset_counts()
    with contextlib.redirect_stdout(log):
        records = eval_cli.main(argv + ["--eval_steps", "10000",
                                        "--gpu_vocoder"])
        records += eval_cli.main(argv + ["--eval_steps", "20000:30000"])
    counts = read_counts()
    log.close()
    calls = sum(r["batches"] for r in records)

    with open(os.path.join(logs, "metrics.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    mse = {str(r["step"]): {m["tag"].split("/", 1)[1]: m["value"]
                            for m in scalars if m["step"] == r["step"] and
                            m["tag"].startswith("mse_dtw/")}
           for r in records}
    missing = {}
    for r in records:
        files = set(os.listdir(os.path.join(logs, "eval_%d" % r["step"])))
        lost = [n + ext for n in names for ext in (".npy", ".wav",
                                                   "_trim.wav")
                if n + ext not in files]
        if lost:
            missing[r["step"]] = lost
    shutil.rmtree(models)
    row = {"phase": "eval_service", "nvidia_smi": smi,
           "hparams": EVAL_HPARAMS, "utterances": len(names),
           "checkpoints": records, "write_s": write_s,
           "formats_bit_identical": identical,
           "synthesize_batch_calls": calls,
           "launches_by_kernel": counts,
           "mha_forward_per_call": counts["mha_forward"] / max(calls, 1),
           "mse_dtw": mse, "missing_files": missing,
           "pickle_one_batch_s": pickle_s,
           "pickle_one_batch_bytes": len(payload),
           "encdec_alignment_bytes": align_bytes,
           "wall_s": time.perf_counter() - tic_phase}
    row["ok"] = identical == {"torch": True, "msgpack": True,
                              "sharded": True} and \
        [r["step"] for r in records] == [10000, 20000, 30000] and \
        [r["format"] for r in records] == ["torch", "msgpack", "sharded"] and \
        all(r["pool"] == "spawn" and r["samples"] == len(names)
            for r in records) and \
        records[0]["vocoder_s"] > 0 and calls == 2 * len(records) and \
        counts == dict(NO_LAUNCHES,
                       mha_forward=hp.n_encoder_layer * calls) and \
        not missing and all(
            sorted(v) == sorted(EVAL_LANGS) and
            all(np.isfinite(x) for x in v.values()) for v in mse.values())
    emit(row)
    if not row["ok"]:
        raise AssertionError("eval_service phase failed: %s" % row)
    return counts


# ---------------------------------------------------------------------------
# phase 9: the train step at flagship width
# ---------------------------------------------------------------------------

def train_step_matmul_flops(hp, b, t_in, t_out) -> float:
    """Analytic matmul FLOPs of one training step (own copy of the JAX
    package's bench.py count): projections, attention logits/context, FFNs,
    prenet/postnet/heads, forward + 2x for backward; norms and elementwise
    work excluded, so the MFU it gives is conservative."""
    he, hd = hp.encoder_hidden, hp.decoder_hidden
    enc = hp.n_encoder_layer * (
        24 * b * t_in * he ** 2          # qkv(3) + out(1) + ffn(8)
        + 4 * b * t_in ** 2 * he)        # attention logits + context
    dec = hp.n_decoder_layer * (
        8 * b * t_out * hd ** 2          # self qkv + out
        + 4 * b * t_out ** 2 * hd        # causal self-attention
        + 4 * b * t_out * hd ** 2        # cross q + out
        + 4 * b * t_in * hd ** 2         # cross kv over the hd-wide memory
        + 4 * b * t_out * t_in * hd      # cross logits + context
        + 16 * b * t_out * hd ** 2)      # ffn
    p = hp.prenet_hidden
    prenet = 2 * b * t_out * (hp.num_mels * p + p * p + p * hd)
    heads_ = 2 * b * t_out * hd * (hp.num_mels + 1)
    ph = hp.postnet_hidden
    post_ch = ([hp.num_mels] + [ph] * (hp.n_postnet_layer - 1) +
               [hp.num_mels])
    postnet = sum(2 * b * t_out * 5 * post_ch[i] * post_ch[i + 1]
                  for i in range(hp.n_postnet_layer))
    return 3.0 * (enc + dec + prenet + heads_ + postnet)


def train_batch(hp, seed, b=16, t_in=192, t_out=448):
    """A synthetic feeder-style batch (numpy) at the flagship train shape;
    the first row has the full lengths."""
    rng = np.random.RandomState(seed + 2)
    input_lengths = rng.randint(t_in // 2, t_in + 1, b).astype(np.int32)
    target_lengths = rng.randint(t_out // 2, t_out + 1, b).astype(np.int32)
    input_lengths[0], target_lengths[0] = t_in, t_out
    mel = np.clip(rng.randn(b, t_out, hp.num_mels), -4, 4).astype(np.float32)
    mel[np.arange(t_out)[None, :] >= target_lengths[:, None]] = 0.0
    return dict(
        inputs=rng.randint(3, 255, (b, t_in)).astype(np.int32),
        input_lengths=input_lengths, mel_targets=mel,
        target_lengths=target_lengths,
        input_spk_ids=rng.randint(0, hp.max_num_speaker, b).astype(np.int32),
        input_language_vecs=np.eye(hp.max_num_language, dtype=np.float32)[
            rng.randint(0, 38, b)])


def loss_and_grads(model, batch, hp):
    """One forward/backward at dropout 0: (loss, {name: grad})."""
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(batch["inputs"], batch["input_lengths"],
                batch["mel_targets"], batch["target_lengths"],
                batch["input_spk_ids"], batch["input_language_vecs"],
                train=True, generator=None)
    loss = compute_loss(model, batch["mel_targets"], batch["target_lengths"],
                        out, hp)["loss"]
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def step_runs(hp, state, batch, dtype):
    """One step at dropout 0 from ``state`` on the card, through the kernels
    and through the plain attention and LayerNorm paths (at hp's head
    count: 8 heads give head dims 64/96, 4 give 128/192): ((loss, grads,
    kernel calls) of the kernel path, (loss, grads) of the plain path)."""
    hp0 = hp.replace(transformer_dropout_rate=0.0, decoder_dropout_rate=0.0,
                     use_bfloat16=dtype == torch.bfloat16)
    kernel = ByteToMel(hp0, device="cuda")
    kernel.load_state_dict(state)
    plain = ByteToMel(hp0.replace(use_pallas_attention=False,
                                  use_fused_layernorm=False), device="cuda")
    plain.load_state_dict(state)
    before = (mha_forward.launches, mha_backward.launches,
              layer_norm_backward.launches)
    loss_k, grads_k = loss_and_grads(kernel, batch, hp0)
    launched = (mha_forward.launches - before[0],
                mha_backward.launches - before[1],
                layer_norm_backward.launches - before[2])
    return (loss_k, grads_k, launched), loss_and_grads(plain, batch, hp0)


def leaf_rel_err(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def step_agreement(hp, dtype, kernel, plain, widen=None):
    """Hold a step_runs pair to TOL_STEP[dtype]; ``widen`` {leaf: (factor,
    readings)} gives the leaves whose gradient cancels a bar of factor x
    the tolerance (see TOL_STEP)."""
    (loss_k, grads_k, launched), (loss_p, grads_p) = kernel, plain
    widen = widen or {}
    tol = TOL_STEP[dtype]
    errs = {n: leaf_rel_err(grads_k[n], grads_p[n]) for n in grads_p}
    bars = {n: tol["grad"] * widen[n][0] if n in widen else tol["grad"]
            for n in errs}
    # the worst leaves with the L2 norm of their plain gradient
    worst = [(n, e, grads_p[n].norm().item()) for n, e in
             sorted(errs.items(), key=lambda kv: -kv[1] / bars[kv[0]])[:5]]
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    row = {"phase": "train_step_agreement", "dtype": str(dtype),
           "n_attention_head": hp.n_attention_head,
           "head_dims": [hp.encoder_hidden // hp.n_attention_head,
                         hp.decoder_hidden // hp.n_attention_head],
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": loss_err, "tol_loss": tol["loss"],
           "grad_leaves": len(errs),
           "max_grad_rel_err": max(errs.values()),
           "median_grad_rel_err": float(np.median(list(errs.values()))),
           "worst_leaves": worst, "tol_grad": tol["grad"],
           "cancelling_leaves": {
               n: {"err": errs[n], "bar": bars[n], **readings}
               for n, (_, readings) in widen.items()},
           "kernel_calls": launched}
    row["ok"] = loss_err <= tol["loss"] and \
        all(errs[n] <= bars[n] for n in errs) and \
        launched == (18, 18, 32) and all(
            bool(torch.isfinite(g).all()) for g in grads_k.values())
    emit(row)
    if not row["ok"]:
        raise AssertionError("the kernel train step disagrees with the plain "
                             "path: %s" % row)


def four_head_agreement(hp, state, batch):
    """The step with 4 heads (head dims 128/192) in bf16 and fp32, kernels
    vs the plain attention and LayerNorm paths.  A leaf whose plain bf16
    gradient lies further than TOL_STEP's bf16 bar from its plain fp32
    gradient cancels: bf16 rounding alone moves it by r > that bar.  Such a
    leaf is held, in both dtypes, to 2 r / bar times the tolerance."""
    hp4 = hp.replace(n_attention_head=4)
    runs = {dtype: step_runs(hp4, state, batch, dtype)
            for dtype in (torch.bfloat16, torch.float32)}
    plain16 = runs[torch.bfloat16][1][1]
    plain32 = runs[torch.float32][1][1]
    bar16 = TOL_STEP[torch.bfloat16]["grad"]
    moved = {n: leaf_rel_err(plain16[n], plain32[n]) for n in plain32}
    cancelling = [n for n, r in moved.items() if r > bar16]
    # which kernel moves them in bf16: kernel attention, plain LayerNorm
    hp_ln = hp4.replace(transformer_dropout_rate=0.0,
                        decoder_dropout_rate=0.0, use_fused_layernorm=False)
    attention_only = ByteToMel(hp_ln, device="cuda")
    attention_only.load_state_dict(state)
    grads_a = loss_and_grads(attention_only, batch, hp_ln)[1]
    first = lambda g: g.flatten()[:3].tolist()
    widen = {}
    for n in cancelling:
        widen[n] = (2 * moved[n] / bar16, {
            "plain_bf16_vs_plain_fp32": moved[n],
            "kernel_bf16": first(runs[torch.bfloat16][0][1][n]),
            "plain_bf16": first(plain16[n]),
            "kernel_attention_plain_layernorm_bf16": first(grads_a[n]),
            "kernel_fp32": first(runs[torch.float32][0][1][n]),
            "plain_fp32": first(plain32[n])})
    for dtype, (kernel, plain) in runs.items():
        step_agreement(hp4, dtype, kernel, plain, widen)


def train_profile(model, optimizer, scheduler, batch, hp, seed, step,
                  wall_ms, phase="train_profile"):
    """One step under torch.profiler: device busy time against the
    unprofiled step time, launches, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(model, optimizer, scheduler, batch, hp,
                   step_generator(seed, step, "cuda"))
        torch.cuda.synchronize()
    kernels, ranges = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the attention kernels of csrc/mha_fwd.cu and csrc/mha_bwd.cu
    attention_ms = sum(e.self_device_time_total for e in kernels
                       if "mha_fwd" in e.key or "mha_bwd" in e.key) / 1e3
    # csrc/layernorm_bwd.cu's kernel (each kernel of a parent's too)
    ln = [e for e in kernels if "ln_bwd" in e.key]
    ln_ms = sum(e.self_device_time_total for e in ln) / 1e3
    return {"phase": phase, "wall_ms_unprofiled": wall_ms,
            "device_busy_ms": busy_ms if kernels else None,
            "attention_device_ms": attention_ms,
            "attention_share_of_busy": attention_ms / busy_ms if busy_ms
            else None,
            "layernorm_bwd_device_ms": ln_ms,
            "layernorm_bwd_launches": sum(e.count for e in ln),
            "layernorm_bwd_share_of_busy": ln_ms / busy_ms if busy_ms
            else None,
            "device_idle_share": 1 - busy_ms / wall_ms if kernels else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": top_events(kernels, 10),
            "annotation_ranges_excluded": top_events(ranges, 8),
            "top_host_ops": [
                {"name": e.key[:60], "count": e.count,
                 "self_cpu_ms": e.self_cpu_time_total / 1e3}
                for e in sorted(prof.key_averages(),
                                key=lambda e: -e.self_cpu_time_total)[:8]]}


def train_phase(seed, steps=10, parent_ln_fn=None):
    """The training path: kernel/plain agreement at dropout 0 (bf16, fp32),
    then ``steps`` Adam steps at the default dropout rates through
    train_step, counted, timed and profiled; with ``parent_ln_fn`` (from
    parent_ln), one more profiled step with the parent's LayerNorm backward
    in place of this one (its device ms and the step's launches)."""
    hp = default_config()
    host = train_batch(hp, seed)
    batch = device_batch(host, hp, "cuda")
    state = init_weights_(ByteToMel(hp, device="cuda"), seed).state_dict()
    for dtype in (torch.bfloat16, torch.float32):
        step_agreement(hp, dtype, *step_runs(hp, state, batch, dtype))
    four_head_agreement(hp, state, batch)

    model = ByteToMel(hp, device="cuda")
    model.load_state_dict(state)
    optimizer, scheduler = make_optimizer(model, hp)
    frames = int(host["target_lengths"].sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times, per_step = [], [], []
    for step in range(steps):
        before = (mha_forward.launches, mha_backward.launches,
                  layer_norm_backward.launches)
        tic = time.perf_counter()
        out = train_step(model, optimizer, scheduler, batch, hp,
                         step_generator(seed, step, "cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - tic)
        losses.append(out["loss"])
        per_step.append((mha_forward.launches - before[0],
                         mha_backward.launches - before[1],
                         layer_norm_backward.launches - before[2]))
    counts = read_counts()
    losses = torch.stack(losses).float().cpu().numpy().tolist()
    sec = float(np.median(times[2:]))
    flops = train_step_matmul_flops(hp, 16, 192, 448)
    row = {"phase": "train", "config": "default_config (flagship)",
           "B": 16, "T_in": 192, "T_out": 448, "steps": steps,
           "dropout": [hp.transformer_dropout_rate, hp.decoder_dropout_rate],
           "losses": losses, "step_s": times, "sec_per_step": sec,
           "frames": frames,
           "audio_s_per_s": frames * hp.frame_shift_ms / 1000.0 / sec,
           "matmul_flops_per_step": flops,
           "mfu": flops / sec / PEAK_FLOPS_PER_S[torch.bfloat16],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "kernel_calls": counts, "kernel_calls_per_step": per_step}
    row["ok"] = all(np.isfinite(losses)) and losses[-1] < losses[0] and \
        all(c == (18, 18, 32) for c in per_step) and \
        counts["decoder_frame_step"] == 0
    emit(row)
    if not row["ok"]:
        raise AssertionError("train phase failed: %s" % row)
    emit(train_profile(model, optimizer, scheduler, batch, hp, seed, steps,
                       sec * 1e3))
    if parent_ln_fn:
        mine = layernorm_ops.layer_norm_backward
        layernorm_ops.layer_norm_backward = parent_ln_fn
        try:
            emit(train_profile(model, optimizer, scheduler, batch, hp, seed,
                               steps + 1, sec * 1e3,
                               phase="train_profile_parent_ln"))
        finally:
            layernorm_ops.layer_norm_backward = mine
    return counts, sec, state


# ---------------------------------------------------------------------------
# phase 10: the training CLI
# ---------------------------------------------------------------------------

# small widths, 4 heads: encoder 128 (D=32), decoder 128 + 16 + 48 = 192
# (D=48, on the D=64 kernel, padded)
CLI_HPARAMS = ("embed_size=128,encoder_hidden=128,decoder_hidden=192,"
               "speaker_embedding_size=16,language_embedding_size=48,"
               "n_attention_head=4,n_encoder_layer=2,n_decoder_layer=2,"
               "prenet_hidden=64,postnet_hidden=64,n_postnet_layer=3,"
               "max_num_speaker=8,max_num_language=8,bucket_size=16,"
               "data_warmup_steps=0,batch_frame_limit=4000,"
               "batch_frame_quad_limit=4000000,max_generation_frames=32,"
               "n_iter=4")


def write_corpus(root, seed, num_mels=80):
    """mels.zip, metadata and id maps: 2 languages x 12 utterances."""
    import io
    import zipfile
    rng = np.random.RandomState(seed)
    rows, spk_to_id, lang_to_id = [], {}, {}
    with zipfile.ZipFile(os.path.join(root, "mels.zip"), "w") as zf:
        for lang in ["en-us", "de-de"]:
            lang_to_id[lang] = len(lang_to_id)
            spk = lang[:2] + "0"
            spk_to_id[spk] = len(spk_to_id)
            for i in range(12):
                name = "%s_%010d" % (spk, i)
                t = int(rng.randint(20, 60))
                buf = io.BytesIO()
                np.save(buf, np.clip(rng.randn(t, num_mels), -4, 4).astype(
                    np.float32))
                zf.writestr(name + ".npy", buf.getvalue())
                rows.append("%s.npy|%d|hello number %d|%s" % (name, t, i,
                                                              lang))
    with open(os.path.join(root, "metadata.train.txt"), "w") as f:
        f.write("\n".join(rows))
    with open(os.path.join(root, "metadata.eval.txt"), "w") as f:
        f.write("\n".join(rows[:2]))
    with open(os.path.join(root, "lang_id.json"), "w") as f:
        json.dump(lang_to_id, f)
    with open(os.path.join(root, "spk_id.json"), "w") as f:
        json.dump(spk_to_id, f)


def train_cli_phase(out_dir, seed):
    import shutil
    from few_shot_transformer_tts_torch.train import cli
    from few_shot_transformer_tts_torch.train.checkpoint import find_ckpt
    root = os.path.join(out_dir, "train_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    write_corpus(root, seed)
    argv = ["--model-dir", os.path.join(root, "models"),
            "--log-dir", os.path.join(root, "logs"), "--data-dir", root,
            "--checkpoint_interval", "3", "--summary_interval", "2",
            "--hparams", CLI_HPARAMS, "--seed", str(seed)]
    # the CLI logs to stdout; its lines (and those of the feeder threads
    # that outlive it) go to a file that stays open
    log = open(os.path.join(root, "train_cli.log"), "w")
    mha_forward.launches = mha_backward.launches = 0
    layer_norm_backward.launches = 0
    with contextlib.redirect_stdout(log):
        tic = time.perf_counter()
        _, step = cli.main(argv + ["--max_steps", "3"])
        first_s = time.perf_counter() - tic
        # a second run resumes from model.ckpt-3 and its feeder state
        _, resumed = cli.main(argv + ["--max_steps", "4"])
    counts = {"mha_forward": mha_forward.launches,
              "mha_backward": mha_backward.launches,
              "layer_norm_backward": layer_norm_backward.launches}
    ckpt = find_ckpt(os.path.join(root, "models"))
    eval_dir = os.path.join(root, "logs", "eval_3")
    row = {"phase": "train_cli", "steps": step, "resumed_to": resumed,
           "wall_s_first_run": first_s, "latest_checkpoint":
           os.path.basename(ckpt or ""), "kernel_calls": counts,
           "feeder_state": os.path.exists(
               os.path.join(root, "logs", "feeder_0.pkl")),
           "eval_wavs": sorted(f for f in os.listdir(eval_dir)
                               if f.endswith(".wav"))
           if os.path.isdir(eval_dir) else []}
    row["ok"] = step == 3 and resumed == 4 and row["feeder_state"] and \
        os.path.exists(os.path.join(root, "models", "model.ckpt-3")) and \
        row["latest_checkpoint"] == "model.ckpt-3" and \
        len(row["eval_wavs"]) > 0 and min(counts.values()) > 0
    emit(row)
    if not row["ok"]:
        raise AssertionError("train CLI phase failed: %s" % row)


# ---------------------------------------------------------------------------
# phase 11: feature extraction through the fused_frame_mel kernel
# ---------------------------------------------------------------------------

def utterances(rng, b, seconds, sr=16000):
    """b voice-like rows of ``seconds`` from the seed: seven harmonics of a
    wandering pitch under a syllable-rate envelope, plus noise."""
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    rows = []
    for _ in range(b):
        pitch = rng.uniform(90, 250) * (1 + 0.1 * np.sin(
            2 * np.pi * rng.uniform(0.2, 1.0) * t))
        phase = 2 * np.pi * np.cumsum(pitch) / sr
        voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t +
                                rng.uniform(0, 2 * np.pi)))
        rows.append(0.3 * env * voiced + 0.01 * rng.randn(n))
    return np.stack(rows).astype(np.float32)


def mel_bound(n_samples, bt, hp):
    """Least time for the kernel's function on ``bt`` frames of a signal of
    ``n_samples``: the signal read once and the mel written once; per frame
    the operations the function needs, a real FFT (~2.5 n log2 n), the
    magnitude of each bin (4) and the mel product over the filterbank's
    nonzero weights, at the fp32 rate.  Beside it the
    operations of a DFT over the window's nonzero taps (the kernel's route)
    and over all n_fft taps (the TPU kernel's products), dense mel product
    included."""
    n_freqs = 1 + hp.n_fft // 2
    taps = int(np.count_nonzero(dsp._padded_window(hp.win_length,
                                                   hp.n_fft)))
    mel_nonzero = int(np.count_nonzero(dsp.mel_filterbank(
        hp.sr, hp.n_fft, hp.num_mels)))
    nbytes = n_samples * 4 + bt * hp.num_mels * 4
    flops_fft = 2.5 * bt * hp.n_fft * np.log2(hp.n_fft)
    flops = flops_fft + 4.0 * bt * n_freqs + 2.0 * bt * mel_nonzero
    dense_mel = 2.0 * bt * n_freqs * hp.num_mels
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS_PER_S[torch.float32] * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops, "flops_fft": flops_fft,
            "mel_weights_nonzero": mel_nonzero, "taps": taps,
            "flops_dft_taps": 4.0 * bt * taps * n_freqs + dense_mel,
            "flops_full_n_fft_dft": 4.0 * bt * hp.n_fft * n_freqs +
            dense_mel}


def check_mel(name, rng, b, seconds, hp, iters=20):
    """fused_frame_mel against fused_frame_mel_plain on one batch of
    pre-emphasised utterances."""
    wav = torch.from_numpy(utterances(rng, b, seconds)).cuda()
    y = dsp_torch.preemphasis(wav, hp.preemphasis)
    before = fused_frame_mel.launches
    got = fused_frame_mel(y, hp)
    launches = fused_frame_mel.launches - before
    want = fused_frame_mel_plain(windowed_frames(y, hp), hp)
    torch.cuda.synchronize()
    err = (got - want).abs()
    row = {"phase": "dsp_kernel_check", "case": name, "B": b,
           "seconds": seconds, "L": wav.shape[1], "T": got.shape[1],
           "BT": b * got.shape[1], "launches_per_call": launches,
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "tol": TOL_MEL, "finite": bool(torch.isfinite(got).all()),
           "ms": cuda_ms(lambda: fused_frame_mel(y, hp), iters),
           "plain_ms": cuda_ms(lambda: fused_frame_mel_plain(
               windowed_frames(y, hp), hp), max(iters // 5, 2)),
           # several calls: framing, cuFFT rfft, |.|, fp32 mel product and
           # the dB epilogue (melspectrogram(use_pallas=False), whose
           # pre-emphasis adds one elementwise op)
           "library_ms": cuda_ms(lambda: dsp_torch.melspectrogram(wav, hp),
                                 iters),
           "library": "melspectrogram(use_pallas=False): rfft route, "
                      "several calls",
           **mel_bound(wav.numel(), b * got.shape[1], hp)}
    row["ok"] = row["max_abs_err"] <= TOL_MEL["max"] and \
        row["mean_abs_err"] <= TOL_MEL["mean"] and row["finite"] and \
        launches == 1 and \
        got.shape == (b, 1 + wav.shape[1] // hp.hop_length, hp.num_mels)
    emit(row)
    if not row["ok"]:
        raise AssertionError("fused_frame_mel disagrees with its plain "
                             "version at %s: %s" % (name, row))
    return row, wav


def dsp_kernel_phase(seed):
    """The kernel at full width (16 utterances of 10 s), at a frame count
    that is not a multiple of its tile and on a short utterance; the fused
    route against the numpy reference; then the main path: one batched
    melspectrogram(use_pallas=True) call, counted."""
    hp = default_config()
    rng = np.random.RandomState(seed + 40)
    rows = {}
    rows["full"], wav = check_mel("full_B16_10s", rng, 16, 10.0, hp)
    check_mel("B3_T99", rng, 3, 1.234, hp)
    check_mel("short_0.4s", rng, 1, 0.4, hp)
    one = wav[:1]
    got = dsp_torch.melspectrogram(one, hp, use_pallas=True)[0].cpu().numpy()
    want = dsp.get_spectrograms(one[0].cpu().numpy(), hp)
    err = np.abs(got - want)
    row = {"phase": "dsp_kernel_check", "case": "fused_route_vs_numpy",
           "seconds": 10.0, "max_abs_err": float(err.max()),
           "mean_abs_err": float(err.mean()), "tol": TOL_MEL_NUMPY}
    row["ok"] = got.shape == want.shape and \
        row["max_abs_err"] <= TOL_MEL_NUMPY["max"] and \
        row["mean_abs_err"] <= TOL_MEL_NUMPY["mean"]
    emit(row)
    if not row["ok"]:
        raise AssertionError("the fused mel route disagrees with numpy: %s"
                             % row)
    # the main path of the kernel: a batch of waveforms to mels
    torch.cuda.synchronize()
    reset_counts()
    tic = time.perf_counter()
    mels = dsp_torch.melspectrogram(wav, hp, use_pallas=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    counts = read_counts()
    row = {"phase": "melspectrogram_batch", "B": wav.shape[0],
           "audio_s": wav.numel() / hp.sr, "wall_s": wall,
           "audio_s_per_s": wav.numel() / hp.sr / wall,
           "launches_by_kernel": counts}
    row["ok"] = counts == dict(NO_LAUNCHES, fused_frame_mel=1) and \
        bool(torch.isfinite(mels).all())
    emit(row)
    if not row["ok"]:
        raise AssertionError("melspectrogram_batch failed: %s" % row)
    rows["counts"] = counts
    return rows


# ---------------------------------------------------------------------------
# phase 12: the fused Adam kernel on the flagship's kernel leaves
# ---------------------------------------------------------------------------

def flagship_kernel_leaf_shapes(hp):
    with torch.device("meta"):
        model = ByteToMel(hp, device="meta")
    return [tuple(p.shape) for p in kernel_leaf_params(model)]


def ulps(got, want):
    """Largest distance in units in the last place between two fp32
    tensors of one sign pattern (0: the same bits)."""
    return (got.view(torch.int32).long() -
            want.view(torch.int32).long()).abs().max().item()


def adam_kernel_phase(seed, iters=20):
    """adam_leaves against adam_leaf_plain on the 37 leaves of the flagship
    that take the kernel, at step 10 with the default betas and eps: one
    launch, the same bits."""
    hp = default_config()
    shapes = flagship_kernel_leaf_shapes(hp)
    gen = torch.Generator("cuda").manual_seed(seed + 50)
    rnd = lambda shape, scale: torch.randn(
        shape, generator=gen, device="cuda") * scale
    p = [rnd(sh, 0.05) for sh in shapes]
    g = [rnd(sh, 1e-2) for sh in shapes]
    m = [rnd(sh, 1e-3) for sh in shapes]
    v = [rnd(sh, 1e-3) ** 2 for sh in shapes]
    t, lr = 10, hp.max_lr
    b1, b2, eps = hp.adam_beta1, hp.adam_beta2, hp.adam_eps
    coef = (lr / (1 - b1 ** t), (1 - b2 ** t) ** -0.5, b1, b2, eps)
    clone = lambda xs: [x.clone() for x in xs]
    pk, mk, vk = clone(p), clone(m), clone(v)
    before = adam_leaves.launches
    adam_leaves(pk, g, mk, vk, *coef)
    launches = adam_leaves.launches - before
    pp, mp, vp = clone(p), clone(m), clone(v)
    adam_leaf_plain(pp, g, mp, vp, *coef)
    torch.cuda.synchronize()
    errs = {"ulps_" + n: max(ulps(a, b) for a, b in zip(got, want))
            for n, got, want in (("p", pk, pp), ("m", mk, mp),
                                 ("v", vk, vp))}
    max_abs = max(abs_err(a, b) for a, b in zip(pk, pp))
    numel = sum(x.numel() for x in p)
    # library: torch.optim.Adam's fused CUDA step over the same leaves
    params = [torch.nn.Parameter(x.clone()) for x in p]
    for q, gr in zip(params, g):
        q.grad = gr
    library = torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                               fused=True)
    nbytes = 28 * numel
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = 13.0 * numel / PEAK_FLOPS_PER_S[torch.float32] * 1e3
    row = {"phase": "adam_kernel_check", "leaves": len(shapes),
           "elements": numel, "launches_per_call": launches, **errs,
           "max_abs_err": max_abs, "tol_ulps": TOL_ADAM_ULPS,
           "ms": cuda_ms(lambda: adam_leaves(pk, g, mk, vk, *coef), iters),
           "plain_ms": cuda_ms(lambda: adam_leaf_plain(pp, g, mp, vp, *coef),
                               max(iters // 4, 2)),
           "library_ms": cuda_ms(library.step, iters),
           "library": "torch.optim.Adam(fused=True).step, timed only",
           "bound_ms": max(t_bytes, t_flops),
           "bound_by": "bytes" if t_bytes >= t_flops else "operations",
           "bytes": nbytes, "flops": 13.0 * numel}
    row["ok"] = len(shapes) == 37 and numel == 61_661_184 and \
        launches == 1 and max(errs.values()) <= TOL_ADAM_ULPS and \
        all(bool(torch.isfinite(x).all()) for x in pk)
    emit(row)
    if not row["ok"]:
        raise AssertionError("adam_leaves disagrees with its plain version: "
                             "%s" % row)
    return row



# ---------------------------------------------------------------------------
# phase 13: the flagship train step with use_fused_adam
# ---------------------------------------------------------------------------

def fused_vs_adam_step(model, optimizer, batch, hp):
    """From one state and one set of gradients: a FusedAdam step against
    torch.optim.Adam (foreach) loaded from FusedAdam's state dict."""
    loss_and_grads(model, batch, hp)
    start = [p.detach().clone() for p in model.parameters()]
    saved = copy.deepcopy(optimizer.state_dict())
    optimizer.step()
    fused = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p, s0 in zip(model.parameters(), start):
            p.copy_(s0)
    adam = torch.optim.Adam(model.parameters(), lr=hp.max_lr,
                            betas=(hp.adam_beta1, hp.adam_beta2),
                            eps=hp.adam_eps, foreach=True)
    adam.load_state_dict(saved)
    adam.step()
    torch.cuda.synchronize()
    diff = max(abs_err(f, p) for f, p in zip(fused, model.parameters()))
    lr = saved["param_groups"][0]["lr"]
    return {"lr": lr, "max_abs_param_diff": diff,
            "max_abs_param": max(p.abs().max().item() for p in fused),
            "max_abs_update": max(abs_err(f, s0)
                                  for f, s0 in zip(fused, start)),
            # further steps of each (the parameters are not used again)
            "fused_adam_step_ms": timed_steps(optimizer),
            "torch_adam_step_ms": timed_steps(adam)}


def timed_steps(optimizer, n=5):
    """Medians over n optimizer steps from an idle card: host ms to queue
    a step, and wall ms until the card has run it."""
    host, wall = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        optimizer.step()
        host.append((time.perf_counter() - tic) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - tic) * 1e3)
    return {"host_ms": float(np.median(host)),
            "wall_ms": float(np.median(wall))}


def train_fused_adam_phase(seed, state, train_sec, steps=10):
    """The flagship train step (bf16, B=16, T_in=192, T_out=448, the train
    phase's batch) for ``steps`` steps with use_fused_adam=True: one
    fused_adam_step launch (adam_leaves over the 37 kernel leaves) and
    18/18/32 attention and LayerNorm kernel calls per step, finite and
    falling losses, one step against
    torch.optim.Adam.  ``state``: the train phase's initial weights (None:
    made from the seed)."""
    hp = default_config(use_fused_adam=True)
    host = train_batch(hp, seed)
    batch = device_batch(host, hp, "cuda")
    if state is None:
        model = init_weights_(ByteToMel(hp, device="cuda"), seed)
    else:
        model = ByteToMel(hp, device="cuda")
        model.load_state_dict(state)
    optimizer, scheduler = make_optimizer(model, hp)
    frames = int(host["target_lengths"].sum())
    torch.cuda.synchronize()
    reset_counts()
    losses, times, per_step = [], [], []
    for step in range(steps):
        before = read_counts()
        tic = time.perf_counter()
        out = train_step(model, optimizer, scheduler, batch, hp,
                         step_generator(seed, step, "cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - tic)
        losses.append(out["loss"])
        after = read_counts()
        per_step.append(tuple(after[k] - before[k] for k in (
            "mha_forward", "mha_backward", "layer_norm_backward",
            "fused_adam_step")))
    counts = read_counts()
    losses = torch.stack(losses).float().cpu().numpy().tolist()
    sec = float(np.median(times[2:]))
    profile = train_profile(model, optimizer, scheduler, batch, hp, seed,
                            steps, sec * 1e3, "train_fused_adam_profile")
    check = fused_vs_adam_step(model, optimizer, batch, hp)
    row = {"phase": "train_fused_adam", "config": "default_config "
           "(flagship), use_fused_adam=True", "B": 16, "T_in": 192,
           "T_out": 448, "steps": steps, "optimizer": type(optimizer).__name__,
           "losses": losses, "step_s": times, "sec_per_step": sec,
           "train_phase_sec_per_step": train_sec,
           "audio_s_per_s": frames * hp.frame_shift_ms / 1000.0 / sec,
           "kernel_calls": counts, "kernel_calls_per_step": per_step,
           "one_step_vs_torch_adam": check, "tol_step": TOL_ADAM_STEP,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    row["ok"] = isinstance(optimizer, FusedAdam) and \
        all(np.isfinite(losses)) and losses[-1] < losses[0] and \
        all(c == (18, 18, 32, 1) for c in per_step) and \
        check["max_abs_param_diff"] <= TOL_ADAM_STEP
    emit(row)
    if not row["ok"]:
        raise AssertionError("train_fused_adam failed: %s" % row)
    emit(profile)
    return counts


# ---------------------------------------------------------------------------
# phase 14: batched Griffin-Lim on the card (vocode_batch)
# ---------------------------------------------------------------------------

def envelope_corr(a, b, n=400):
    k = min(len(a), len(b))
    env = lambda x: np.sqrt(np.convolve(x[:k] ** 2, np.ones(n) / n, "valid"))
    return float(np.corrcoef(env(a), env(b))[0, 1])


def vocode_phase(mel_aft, lengths, hp):
    """vocode_batch on the eager main path's mels (B=8, 512 frames,
    hp.n_iter iterations): seconds, audio s/s and the per-sample numpy
    mel2wav on the host; two calls the same bits; at n_iter=2 one row
    against the numpy path by envelope correlation."""
    torch.cuda.synchronize()
    tic = time.perf_counter()
    first = vocode_batch(mel_aft, lengths, hp)   # builds the cuFFT plans
    wall_first = time.perf_counter() - tic
    tic = time.perf_counter()
    wavs = vocode_batch(mel_aft, lengths, hp)
    wall = time.perf_counter() - tic
    n0 = int(lengths[0])
    hp2 = hp.replace(n_iter=2)   # (this also imports scipy for the timing)
    corr = envelope_corr(vocode_batch(mel_aft[:1], lengths[:1], hp2)[0],
                         dsp.mel2wav(mel_aft[0][:n0], hp2))
    tic = time.perf_counter()
    dsp.mel2wav(mel_aft[0][:n0], hp)
    numpy_s = time.perf_counter() - tic
    audio_s = sum(len(w) for w in wavs) / hp.sr
    row = {"phase": "vocode", "B": len(wavs), "frames": [int(x) for x in
                                                        lengths],
           "n_iter": hp.n_iter, "wall_s": wall,
           "wall_s_first_call": wall_first, "audio_s": audio_s,
           "audio_s_per_s": audio_s / wall,
           "numpy_mel2wav_one_utterance_s": numpy_s,
           "repeat_bit_identical": all(np.array_equal(a, b)
                                       for a, b in zip(wavs, first)),
           "n_iter2_envelope_corr_vs_numpy": corr,
           "finite": all(np.isfinite(w).all() for w in wavs),
           # a row that ran to the cap counts one frame more than it has
           "lengths_ok": [len(w) for w in wavs] ==
           [(min(int(x), mel_aft.shape[1]) - 1) * hp.hop_length
            for x in lengths]}
    row["ok"] = row["repeat_bit_identical"] and corr > 0.9 and \
        row["finite"] and row["lengths_ok"]
    emit(row)
    if not row["ok"]:
        raise AssertionError("vocode phase failed: %s" % row)


# ---------------------------------------------------------------------------
# phase 15: the corpus pipeline, its mels stage on fused_frame_mel
# ---------------------------------------------------------------------------

# utterances a corpus: above min_speaker_samples' 100 after the rejects
CORPUS_UTTERANCES = 120
CORPUS_WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india "
                "juliet kilo lima mike november oscar papa quebec romeo "
                "sierra tango uniform victor whiskey xray yankee zulu").split()
# the flagship's hparams but for bucketing and the data warm-up
CORPUS_HPARAMS = "bucket_size=64,data_warmup_steps=0"
PACKED_FILES = ("metadata.train.txt", "metadata.eval.txt", "lang_id.json",
                "spk_id.json", "lang_stat.tsv")


def raw_utterance(rng, seconds, sr):
    """Voice-like audio (``utterances``) between quiet edges, int16."""
    quiet = lambda: 1e-4 * rng.randn(int(rng.uniform(0.05, 0.4) * sr))
    y = np.concatenate([quiet(), utterances(rng, 1, seconds, sr)[0],
                        quiet()])
    return (np.clip(y, -1, 1) * 32767).astype(np.int16)


def write_raw_corpora(raw, seed, sr=22050):
    """The LJSpeech, thorsten and CSS10 German layouts (22,050 Hz int16, the
    published corpora's format), CORPUS_UTTERANCES utterances of 1.5-18 s
    each; in each,
    utterance 0 has a 1.5 s pause (the trim stage rejects it for its gap),
    1 and 2 last 0.4 s and 21 s (rejected for length), and in thorsten and
    CSS10 row 3 holds a digit (the readers skip it).  Returns the seconds of
    audio written."""
    from scipy.io import wavfile
    rng = np.random.RandomState(seed + 50)
    layouts = {
        "lj": (os.path.join(raw, "LJSpeech-1.1"), "metadata.csv",
               "wavs/LJ001-%04d.wav", "{name}|raw|{text}"),
        "th": (os.path.join(raw, "thorsten-de_v02", "thorsten-de"),
               "metadata_train.csv", "wavs/th%04d.wav",
               "{name}|{text}|{text}"),
        "css": (os.path.join(raw, "css10_de"), "transcript.txt",
                "buch/buch_%04d.wav", "{rel}|raw|{text}|1.0")}
    total = 0
    for key, (root, meta, wav, row) in layouts.items():
        rows = []
        for i in range(CORPUS_UTTERANCES):
            rel = wav % i
            if i == 0:
                y = np.concatenate([raw_utterance(rng, 3.0, sr),
                                    np.zeros(int(1.5 * sr), np.int16),
                                    raw_utterance(rng, 3.0, sr)])
            else:
                y = raw_utterance(rng, {1: 0.4, 2: 21.0}.get(
                    i, rng.uniform(1.5, 18.0)), sr)
            os.makedirs(os.path.dirname(os.path.join(root, rel)),
                        exist_ok=True)
            wavfile.write(os.path.join(root, rel), sr, y)
            total += len(y) / sr
            text = " ".join(rng.choice(CORPUS_WORDS, 8))
            if i == 3 and key != "lj":
                text += " 42"
            rows.append(row.format(name=os.path.basename(rel)[:-4], rel=rel,
                                   text=text))
        with open(os.path.join(root, meta), "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
    return total


def packed_mels(packed):
    import io
    import zipfile
    with zipfile.ZipFile(os.path.join(packed, "mels.zip")) as zf:
        return {n: np.load(io.BytesIO(zf.read(n))) for n in zf.namelist()}


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def corpus_batch_check(tree, hp, iters=20):
    """The kernel against its plain version on the card, on the largest
    batch the mels stage gave LJSpeech (the same wavs, packed as the stage
    packs them), with its times beside the bound and the rfft route; then
    a batch of utterances voiced to their edges against the plain version;
    and each row of both against the kernel's call on that row alone."""
    from few_shot_transformer_tts_torch.corpora.common import wav_duration
    from few_shot_transformer_tts_torch.corpora.process_corpus import \
        mel_batches
    from few_shot_transformer_tts_torch.ops.mel import (
        fused_frame_mel_ragged, fused_frame_mel_ragged_plain)
    corpus = os.path.join(tree, "ljspeech")
    with open(os.path.join(corpus, "metadata.csv"), encoding="utf-8") as f:
        wavs = [os.path.join(corpus, "proc_wavs", l.split("|")[0] + ".wav")
                for l in f.read().splitlines()]
    lengths = [round(wav_duration(w) * hp.sr) for w in wavs]
    batch = max(mel_batches(lengths, hp), key=lambda b: sum(
        1 + lengths[i] // hp.hop_length for i in b))
    rows = [torch.from_numpy(dsp.load_wav(wavs[i], hp.sr)) for i in batch]
    signal, starts, frames = dsp_torch.pack_ragged(rows, hp)
    signal = signal.cuda()
    got = fused_frame_mel_ragged(signal, starts, frames, hp)
    want = fused_frame_mel_ragged_plain(signal, starts, frames, hp)
    torch.cuda.synchronize()
    err = (got - want).abs()
    basis = dsp_torch.device_constant(
        ("mel_basis", hp.sr, hp.n_fft, hp.num_mels),
        lambda: dsp.get_mel_basis(hp).T, signal.device)
    win = dsp_torch.window(hp, signal.device)
    rfft_route = lambda: dsp_torch.normalize_db(torch.fft.rfft(torch.cat([
        signal[s:s + (t - 1) * hp.hop_length + hp.n_fft].unfold(
            0, hp.n_fft, hp.hop_length) for s, t in zip(starts, frames)]) *
        win).abs() @ basis, hp)
    row = {"phase": "corpus_batch_check", "B": len(rows),
           "lengths": [r.shape[0] for r in rows], "N": signal.shape[0],
           "BT": got.shape[0],
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "tol": TOL_MEL, "finite": bool(torch.isfinite(got).all()),
           "ms": cuda_ms(lambda: fused_frame_mel_ragged(
               signal, starts, frames, hp), iters),
           "plain_ms": cuda_ms(lambda: fused_frame_mel_ragged_plain(
               signal, starts, frames, hp), max(iters // 5, 2)),
           # several calls: framing, cuFFT rfft, |.|, fp32 mel product and
           # the dB epilogue on the same packed rows
           "library_ms": cuda_ms(rfft_route, iters),
           "library": "rfft route on the packed rows, several calls",
           # the kernel's own device time (torch.profiler)
           "kernels_ms": kernel_split_ms(lambda: fused_frame_mel_ragged(
               signal, starts, frames, hp)),
           "host_us": host_us(lambda: fused_frame_mel_ragged(
               signal, starts, frames, hp)),
           **mel_bound(signal.shape[0], got.shape[0], hp)}
    # utterances voiced to their edges (a trimmed one starts and ends in
    # 1600 / 2400 zeros, where a frame read from the wrong row or past a
    # row's end can still be all zeros)
    rng = np.random.RandomState(7)
    voiced = [torch.from_numpy(utterances(rng, 1, s)[0])
              for s in (1.3, 2.9, 4.4, 7.05)]
    v_signal, v_starts, v_frames = dsp_torch.pack_ragged(voiced, hp)
    v_got = fused_frame_mel_ragged(v_signal.cuda(), v_starts, v_frames, hp)
    v_err = (v_got - fused_frame_mel_ragged_plain(
        v_signal.cuda(), v_starts, v_frames, hp)).abs()
    row.update(voiced_max_abs_err=v_err.max().item(),
               voiced_mean_abs_err=v_err.mean().item())
    # each row of both batches is the kernel's mel of that utterance alone
    single = lambda w: fused_frame_mel(dsp_torch.preemphasis(
        w[None], hp.preemphasis).cuda(), hp)[0].cpu()
    row["ragged_equals_single"] = all(
        torch.equal(m, single(w))
        for ws, out, fr in ((rows, got, frames), (voiced, v_got, v_frames))
        for w, m in zip(ws, out.cpu().split(fr)))
    row["ok"] = row["max_abs_err"] <= TOL_MEL["max"] and \
        row["mean_abs_err"] <= TOL_MEL["mean"] and row["finite"] and \
        row["voiced_max_abs_err"] <= TOL_MEL["max"] and \
        row["voiced_mean_abs_err"] <= TOL_MEL["mean"] and \
        row["ragged_equals_single"] and got.shape[0] == sum(frames)
    emit(row)
    if not row["ok"]:
        raise AssertionError("fused_frame_mel_ragged disagrees with its "
                             "plain version or with single calls: %s" % row)
    return row


def mels_stage_split(tree, hp):
    """The kernel's mels stage replayed serially over the same batches, its
    host seconds by step: reading the wavs, packing them (pre-emphasis and
    reflect padding on the host), the copy to the card, the launch and the
    copy back, and writing the .npy bytes (to memory)."""
    import io
    from few_shot_transformer_tts_torch.corpora import process_corpus as pc
    from few_shot_transformer_tts_torch.corpora.common import wav_duration
    from few_shot_transformer_tts_torch.ops.mel import fused_frame_mel_ragged
    split = dict.fromkeys(("read", "pack", "card", "save"), 0.0)
    for corpus in sorted(os.listdir(tree)):
        jobs = pc._mel_jobs(os.path.join(tree, corpus))
        lengths = [round(wav_duration(w) * hp.sr) for w, _ in jobs]
        for batch in pc.mel_batches(lengths, hp):
            t0 = time.perf_counter()
            wavs = [torch.from_numpy(dsp.load_wav(jobs[i][0], hp.sr))
                    for i in batch]
            t1 = time.perf_counter()
            signal, starts, frames = dsp_torch.pack_ragged(wavs, hp)
            t2 = time.perf_counter()
            mel = fused_frame_mel_ragged(signal.cuda(), starts, frames,
                                         hp).cpu()
            t3 = time.perf_counter()
            for m in mel.split(frames):
                np.save(io.BytesIO(), m.numpy())
            t4 = time.perf_counter()
            for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                split[key] += dt
    return split


def stage_seconds(text, name):
    """The wall time the packer's CLI printed for a stage."""
    return float(re.findall(r"^%s stage: ([0-9.]+) s$" % name, text,
                            re.M)[-1])


def corpus_phase(out_dir, seed, smi):
    """Raw LJSpeech, thorsten and CSS10 German layouts through the port's
    readers and ``python -m few_shot_transformer_tts_torch.corpora.
    process_corpus``, the mels stage twice: ``--device cpu`` (the numpy
    pool) as its own process into one copy of the tree and the default
    ``--device cuda`` in-process into another; then 3 flagship train steps
    on the kernel-built packed tree."""
    import io
    import shutil
    from few_shot_transformer_tts_torch.corpora import datasets
    from few_shot_transformer_tts_torch.corpora import process_corpus as pc
    from few_shot_transformer_tts_torch.corpora.common import wav_duration
    from few_shot_transformer_tts_torch.train import cli
    hp = default_config()
    root = os.path.join(out_dir, "corpus")
    shutil.rmtree(root, ignore_errors=True)
    raw = os.path.join(root, "raw")
    trees = {k: os.path.join(root, k, "transformed")
             for k in ("numpy", "kernel")}
    packs = {k: os.path.join(root, k, "packed") for k in trees}
    wall = {}
    tic = time.perf_counter()
    raw_s = write_raw_corpora(raw, seed)
    wall["write_raw"] = time.perf_counter() - tic
    log = open(os.path.join(root, "corpus.log"), "w")

    def stage(name, tree):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            pc.main(["--transformed", trees[tree], "--packed", packs[tree],
                     "--stages", name.split(":")[0]])
        log.write(out.getvalue())
        wall[name] = stage_seconds(out.getvalue(), name.split(":")[0])

    tic = time.perf_counter()
    with contextlib.redirect_stdout(log):
        datasets.prepare_ljspeech(raw, trees["numpy"])
        datasets.prepare_thorsten(raw, trees["numpy"])
        datasets.prepare_css10(raw, trees["numpy"], langs=["de_de"])
    wall["readers"] = time.perf_counter() - tic
    stage("trim", "numpy")
    stage("meta", "numpy")
    shutil.copytree(trees["numpy"], trees["kernel"])
    names, audio_s, batch_frames, bound_ms = {}, 0.0, [], 0.0
    for corpus in ("ljspeech", "thorsten", "css10_de"):
        d = os.path.join(trees["kernel"], corpus)
        with open(os.path.join(d, "metadata.csv"), encoding="utf-8") as f:
            names[corpus] = [l.split("|")[0] for l in f.read().splitlines()]
        secs = [wav_duration(os.path.join(d, "proc_wavs", n + ".wav"))
                for n in names[corpus]]
        audio_s += sum(secs)
        lengths = [round(s * hp.sr) for s in secs]
        for b in pc.mel_batches(lengths, hp):
            batch_frames.append(sum(1 + lengths[i] // hp.hop_length
                                    for i in b))
            bound_ms += mel_bound(sum(lengths[i] + hp.n_fft for i in b),
                                  batch_frames[-1], hp)["bound_ms"]
    # the numpy stage as a user runs it: its own process, no CUDA in it, a
    # forked pool of --workers (default: the machine's cores)
    tic = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "few_shot_transformer_tts_torch.corpora.process_corpus",
         "--transformed", trees["numpy"], "--packed", packs["numpy"],
         "--stages", "mels", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    wall["mels:numpy_process"] = time.perf_counter() - tic
    log.write(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError("the numpy mels stage exited %d: %s"
                           % (proc.returncode, proc.stderr[-2000:]))
    wall["mels:numpy"] = stage_seconds(proc.stdout, "mels")
    torch.cuda.synchronize()
    reset_counts()
    stage("mels:kernel", "kernel")
    counts = read_counts()
    split = mels_stage_split(trees["kernel"], hp)
    for tree in trees:
        stage("merge:" + tree, tree)
        stage("stats:" + tree, tree)
    log.close()

    # the two packed trees: the same files but for the mel values
    same_files = {f: read_bytes(os.path.join(packs["kernel"], f)) ==
                  read_bytes(os.path.join(packs["numpy"], f))
                  for f in PACKED_FILES}
    got, want = packed_mels(packs["kernel"]), packed_mels(packs["numpy"])
    shapes_equal = sorted(got) == sorted(want) and all(
        got[n].shape == want[n].shape and got[n].dtype == np.float32
        for n in want)
    errs = np.array([[np.abs(got[n] - want[n]).max(),
                      np.abs(got[n] - want[n]).mean()] for n in want]) \
        if shapes_equal else np.full((1, 2), np.inf)
    with open(os.path.join(packs["kernel"], "metadata.train.txt"),
              encoding="utf-8") as f:
        train_rows = f.read().splitlines()
    row = {"phase": "corpus", "nvidia_smi": smi, "raw_audio_s": raw_s,
           "utterances_written": 3 * CORPUS_UTTERANCES,
           "utterances_kept": {c: len(v) for c, v in names.items()},
           "packed_audio_s": audio_s, "mels": len(want),
           "train_rows": len(train_rows), "wall_s": wall,
           "mels_audio_s_per_s": {
               "numpy_pool_%d_workers" % os.cpu_count():
               audio_s / wall["mels:numpy"],
               "kernel": audio_s / wall["mels:kernel"]},
           # the kernel computes each utterance's frames and no others
           "batches": len(batch_frames), "stage_frames": sum(batch_frames),
           "frames_per_batch": batch_frames,
           "stage_bound_ms": float(bound_ms),
           "kernel_stage_serial_split_s": split,
           "launches_by_kernel": counts,
           "same_packed_files": same_files, "same_mel_shapes": shapes_equal,
           "max_abs_err_vs_numpy": float(errs[:, 0].max()),
           "worst_mean_abs_err_vs_numpy": float(errs[:, 1].max()),
           "tol": TOL_MEL_NUMPY}
    # what the inputs were made to exercise: per corpus one gap and two
    # length rejects, and the digit row in thorsten and CSS10
    row["ok"] = all(same_files.values()) and shapes_equal and \
        row["max_abs_err_vs_numpy"] <= TOL_MEL_NUMPY["max"] and \
        row["worst_mean_abs_err_vs_numpy"] <= TOL_MEL_NUMPY["mean"] and \
        counts == dict(NO_LAUNCHES, fused_frame_mel=len(batch_frames)) and \
        row["utterances_kept"] == {"ljspeech": CORPUS_UTTERANCES - 3,
                                   "thorsten": CORPUS_UTTERANCES - 4,
                                   "css10_de": CORPUS_UTTERANCES - 4} and \
        len(train_rows) > 0
    emit(row)
    if not row["ok"]:
        raise AssertionError("corpus phase failed: %s" % row)
    batch = corpus_batch_check(trees["kernel"], hp)

    # three flagship train steps on the kernel-built packed tree
    models = os.path.join(root, "models")
    argv = ["--model-dir", models, "--log-dir", os.path.join(root, "logs"),
            "--data-dir", packs["kernel"], "--max_steps", "3",
            "--checkpoint_interval", "1000", "--summary_interval", "1000",
            "--log_interval", "1", "--hparams", CORPUS_HPARAMS,
            "--seed", str(seed)]
    train_log = os.path.join(root, "train.log")
    tic = time.perf_counter()
    with open(train_log, "w") as f, contextlib.redirect_stdout(f):
        _, step = cli.main(argv)
    wall["train_3_steps"] = time.perf_counter() - tic
    with open(train_log) as f:
        losses = [float(x) for x in re.findall(
            r"\] .*?, loss=([^,]+),", f.read())]
    row = {"phase": "corpus_train", "steps": step, "losses": losses,
           "wall_s": wall["train_3_steps"],
           "hparams": CORPUS_HPARAMS}
    row["ok"] = step == 3 and len(losses) == 3 and \
        all(np.isfinite(losses))
    emit(row)
    if not row["ok"]:
        raise AssertionError("training on the packed corpus failed: %s"
                             % row)
    return {"counts": counts, "batch": batch}


# ---------------------------------------------------------------------------
# phase 16: the convergence path (train CLI, a live eval service, the report)
# ---------------------------------------------------------------------------

CONVERGE_STEPS = 1000
CONVERGE_CKPT_INTERVAL = 500
# mse_loss window mean over steps 901-1000: at most 2x the JAX package's
# flagship record at the same steps, 0.339 (the mean of the 10-step samples
# 901-991 in converge_r05_flagship/train_steps_sampled.log)
CONVERGE_MSE_GATE = 0.678
# share of the eval samples whose eager and fused decodes of ckpt-1000 stop
# at one length: at 1000 steps the stop head is not yet confident, so a
# one-frame flip near its threshold is allowed
CONVERGE_SAME_LENGTH = 0.75


def converge_phase(out_dir, seed, smi):
    """The learnable corpus (tools/make_learnable_corpus.py, its defaults),
    1000 steps of ``python -m few_shot_transformer_tts_torch.train`` at the
    flagship width as a process on the card, the eval service as a second
    process watching the same model dir (checkpoints 500 and 1000 scored as
    they land), then ``convergence.py`` in-process on ckpt-1000, its eager
    and fused decodes counted: the ``converge_report`` path."""
    import shutil
    from few_shot_transformer_tts_torch import convergence
    from few_shot_transformer_tts_torch import converge_run as cr
    tic = time.perf_counter()
    root = os.path.join(out_dir, "converge")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # the in-process CLIs of earlier phases left the root logger on files
    # they have closed, and their Feeder threads still log: from here on
    # it writes to this phase's log
    logging.root.handlers = [logging.FileHandler(os.path.join(root,
                                                              "phase.log"))]
    corpus = os.path.join(root, "corpus")
    run = os.path.join(root, "run")
    models, logs, eval_logs = (os.path.join(run, d) for d in
                               ("models", "logs", "eval_logs"))
    cr.write_corpus(corpus)
    ival = CONVERGE_CKPT_INTERVAL
    train_s, tail_s = cr.run_segment(
        cr.train_argv(corpus, models, logs, CONVERGE_STEPS, ival,
                      cr.LEARNABLE_HPARAMS, "cuda", seed),
        cr.eval_argv(corpus, models, eval_logs, cr.LEARNABLE_HPARAMS, "cuda",
                     cr.TRAIN_LANGS, start_step=ival, eval_interval=ival,
                     scan_interval=5),
        eval_logs, (ival, CONVERGE_STEPS), cr.TRAIN_LANGS,
        os.path.join(root, "segment"), train_timeout=600, watch_tail=120)
    rows = cr.step_lines(logs)
    busy = cr.eval_intervals(eval_logs)
    scores = cr.scored(os.path.join(eval_logs, "metrics.jsonl"))
    tmp_left = sorted(f for f in os.listdir(models) if f.endswith(".tmp"))

    reset_counts()
    with open(os.path.join(root, "report.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        report_tic = time.perf_counter()
        summary = convergence.main([
            "--run-dir", run, "--corpus", corpus, "--out-dir",
            os.path.join(root, "report"), "--ckpt", os.path.join(
                models, "model.ckpt-%d" % CONVERGE_STEPS)])
        report_s = time.perf_counter() - report_tic
    counts = read_counts()
    agree = summary["decode_agreement"]
    same = sum(a["eager_frames"] == a["fused_frames"] for a in agree)
    window = cr.window_mse(rows, 901, CONVERGE_STEPS)
    row = {
        "phase": "converge", "nvidia_smi": smi, "steps": len(rows),
        "train_s": train_s, "watch_tail_s": tail_s, "report_s": report_s,
        "s_per_step_100_1000": cr.step_seconds(rows, busy, 100,
                                               CONVERGE_STEPS),
        "eval_s_per_checkpoint": {s: sec for _, _, sec, s in busy},
        "mse_window_901_1000": window, "mse_gate": CONVERGE_MSE_GATE,
        "mse_first_20": cr.window_mse(rows, 1, 20),
        "eval_mse_dtw": {str(s): v for s, v in sorted(scores.items())},
        "tmp_left": tmp_left, "report_launches": counts,
        "decode_dtw_mse_mean": {
            "eager": summary["ar_decode_dtw_mse_mean"],
            "fused": summary["fused_decode"]["ar_decode_dtw_mse_mean"]},
        "best_head_r2_median": float(np.median(
            [r["r2"] for r in summary["alignment_diagonality"]])),
        "samples": [[r["name"], a["eager_frames"], a["fused_frames"],
                     r["target_frames"], a["max_abs_mel_diff"]]
                    for r, a in zip(summary["alignment_diagonality"],
                                    agree)],
        "same_length": [same, len(agree)]}
    row["seconds"] = time.perf_counter() - tic
    finite = [np.isfinite(r[3]) and np.isfinite(r[4]) for r in rows]
    row["ok"] = (
        [r[1] for r in rows] == list(range(1, CONVERGE_STEPS + 1)) and
        all(finite) and window <= CONVERGE_MSE_GATE and
        all(np.isfinite(scores.get(s, {}).get(lang, np.nan))
            for s in (ival, CONVERGE_STEPS)
            for lang in cr.TRAIN_LANGS.split(":")) and
        not tmp_left and len(agree) > 0 and
        same >= CONVERGE_SAME_LENGTH * len(agree) and
        counts["mha_forward"] > 0 and counts["decoder_frame_step"] > 0)
    emit(row)
    if not row["ok"]:
        raise AssertionError("converge phase failed: %s" % row)
    return {"counts": counts}


# ---------------------------------------------------------------------------
# phase 17: data-parallel training (DDP) and the sharded checkpoint writer
# ---------------------------------------------------------------------------

DDP_ROWS = (7, 9)         # the ranks' rows of the B=16 batch in part (b)
DDP_STEP_KERNELS = ("mha_forward", "mha_backward", "layer_norm_backward")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def count_delta(before):
    after = read_counts()
    return {k: after[k] - before[k] for k in after}


def add_counts(total, delta):
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v


def ddp_rank_rows(host, rank, multiple=8):
    """Rank ``rank``'s rows of the global batch (DDP_ROWS), cropped to its
    own padded shape (its longest lengths rounded up to ``multiple``)."""
    start = sum(DDP_ROWS[:rank])
    local = {k: v[start:start + DDP_ROWS[rank]] for k, v in host.items()}
    t_in = -(-int(local["input_lengths"].max()) // multiple) * multiple
    t_out = -(-int(local["target_lengths"].max()) // multiple) * multiple
    local["inputs"] = local["inputs"][:, :t_in]
    local["mel_targets"] = local["mel_targets"][:, :t_out]
    return {k: np.ascontiguousarray(v) for k, v in local.items()}


def ddp_hparams():
    return default_config(transformer_dropout_rate=0.0,
                          decoder_dropout_rate=0.0, use_fused_adam=True)


def ddp_gloo_rank(rank, port, seed, steps, out_dir):
    """Part (b), one rank (a spawned process): its rows of the flagship
    batch under DDP over gloo as the train CLI builds it (``make_grid``,
    ``parallel_step_model``), both ranks on cuda:0, ``steps`` steps with
    use_fused_adam; writes its losses, launches per step and parameters."""
    from few_shot_transformer_tts_torch.parallel import mesh
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://localhost:%d" % port, rank=rank,
        world_size=len(DDP_ROWS))
    try:
        hp = ddp_hparams()
        model = init_weights_(ByteToMel(hp, device="cuda"), seed)
        optimizer, scheduler = make_optimizer(model, hp)
        grid = mesh.make_grid(1)
        ddp = parallel_step_model(model, grid, torch.device("cuda", 0))
        group = grid.stats_group
        batch = device_batch(ddp_rank_rows(train_batch(hp, seed), rank), hp,
                             "cuda")
        losses, per_step = [], []
        reset_counts()
        for step in range(steps):
            before = read_counts()
            out = train_step(ddp, optimizer, scheduler, batch, hp,
                             step_generator(seed, step, "cuda", rank), group)
            torch.cuda.synchronize()
            losses.append(float(out["loss"]))
            per_step.append(count_delta(before))
        torch.save({"losses": losses, "per_step": per_step,
                    "shape": list(batch["mel_targets"].shape),
                    "fused": isinstance(optimizer, FusedAdam),
                    "params": {n: p.detach().cpu() for n, p in
                               model.named_parameters()}},
                   os.path.join(out_dir, "rank%d.pt" % rank))
    finally:
        torch.distributed.destroy_process_group()


def ddp_world1(hp, host, seed, steps, smi):
    """Part (a): ``steps`` flagship steps (bf16, dropout 0) through the
    DDP-wrapped step at world 1 over NCCL, in turns with the same steps on
    an unwrapped model: losses and gradients held to TOL_STEP, the kernel
    launches of each DDP step, the median sec/step of steps 3-10 of each."""
    port = free_port()
    torch.distributed.init_process_group(
        "nccl", init_method="tcp://localhost:%d" % port, rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        state = init_weights_(ByteToMel(hp, device="cuda"), seed).state_dict()
        models = {}
        for kind in ("plain", "ddp"):
            model = ByteToMel(hp, device="cuda")
            model.load_state_dict(state)
            opt, sched = make_optimizer(model, hp)
            step_model = torch.nn.parallel.DistributedDataParallel(
                model, device_ids=[0], broadcast_buffers=False) \
                if kind == "ddp" else model
            models[kind] = (model, step_model, opt, sched)
        batch = device_batch(host, hp, "cuda")
        counts, times, losses, per_step = {}, {"plain": [], "ddp": []}, \
            {"plain": [], "ddp": []}, []
        loss_err, grad_err = [], []
        for step in range(steps):
            for kind in ("plain", "ddp"):
                model, step_model, opt, sched = models[kind]
                before = read_counts()
                tic = time.perf_counter()
                out = train_step(step_model, opt, sched, batch, hp,
                                 step_generator(seed, step, "cuda"))
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - tic)
                losses[kind].append(float(out["loss"]))
                if kind == "ddp":
                    delta = count_delta(before)
                    add_counts(counts, delta)
                    per_step.append(tuple(delta[k]
                                          for k in DDP_STEP_KERNELS))
            grads = [{n: p.grad for n, p in models[k][0].named_parameters()}
                     for k in ("plain", "ddp")]
            loss_err.append(abs(losses["ddp"][-1] - losses["plain"][-1]) /
                            abs(losses["plain"][-1]))
            grad_err.append(max(leaf_rel_err(grads[1][n], grads[0][n])
                                for n in grads[0]))
        del models, state
    finally:
        torch.distributed.destroy_process_group()
    tol = TOL_STEP[torch.bfloat16]
    sec = {k: float(np.median(v[2:])) for k, v in times.items()}
    row = {"phase": "ddp", "part": "a_world1_nccl", "nvidia_smi": smi,
           "steps": steps, "losses_ddp": losses["ddp"],
           "losses_plain": losses["plain"],
           "max_loss_rel_err": max(loss_err), "tol_loss": tol["loss"],
           "max_grad_rel_err": max(grad_err), "tol_grad": tol["grad"],
           "kernel_calls_per_step": per_step,
           "sec_per_step_ddp": sec["ddp"], "sec_per_step_plain": sec["plain"],
           "ddp_over_plain": sec["ddp"] / sec["plain"],
           "step_s_ddp": times["ddp"], "step_s_plain": times["plain"]}
    row["ok"] = max(loss_err) <= tol["loss"] and \
        max(grad_err) <= tol["grad"] and \
        all(c == (18, 18, 32) for c in per_step) and \
        all(np.isfinite(losses["ddp"]))
    emit(row)
    if not row["ok"]:
        raise AssertionError("ddp part (a) failed: %s" % row)
    return counts


def ddp_world2(host, seed, out_dir, smi, steps=3):
    """Part (b): two ranks over gloo on cuda:0 (one card cannot host two
    NCCL ranks), rows split 7/9 and cropped per rank, against a world-1 run
    over the global batch in this process.  Each parameter leaf is held to
    TOL_STEP's gradient bar, or to twice its shift between two world-1 runs
    that differ only in zero padding where that is wider: after Adam's
    first step (lr x the gradient's sign on every element) a zero-init
    bias whose gradient sums to near zero (the postnet BatchNorm biases)
    moves by bf16 rounding alone."""
    import shutil
    hp = ddp_hparams()
    root = os.path.join(out_dir, "ddp_gloo")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.multiprocessing.start_processes(
        ddp_gloo_rank, args=(free_port(), seed, steps, root),
        nprocs=len(DDP_ROWS), start_method="spawn")
    ranks = [torch.load(os.path.join(root, "rank%d.pt" % r),
                        weights_only=True) for r in range(len(DDP_ROWS))]
    shutil.rmtree(root)
    runs = {}
    for kind, batch in (("world1", host), ("padded", pad_time(host, 8))):
        model = init_weights_(ByteToMel(hp, device="cuda"), seed)
        optimizer, scheduler = make_optimizer(model, hp)
        dbatch = device_batch(batch, hp, "cuda")
        losses = [float(train_step(model, optimizer, scheduler, dbatch, hp,
                                   step_generator(seed, step, "cuda"))["loss"])
                  for step in range(steps)]
        runs[kind] = (losses, {n: p.detach().cpu()
                               for n, p in model.named_parameters()})
    want, params = runs["world1"]
    tol = TOL_STEP[torch.bfloat16]
    errs = {n: leaf_rel_err(ranks[0]["params"][n], params[n])
            for n in params}
    # the same steps over the batch padded by 8 more frames and bytes,
    # masked out everywhere: a leaf whose bf16 rounding moves it further
    # than the bar is held to twice that shift (two runs, each that far)
    shift = {n: leaf_rel_err(runs["padded"][1][n], params[n])
             for n in params}
    bars = {n: max(tol["grad"], 2 * shift[n]) for n in params}
    param_err = max(errs.values())
    worst = [(n, errs[n], bars[n], params[n].numel(),
              params[n].norm().item()) for n in sorted(
                  errs, key=lambda n: -errs[n] / bars[n])[:8]]
    flat = lambda d: torch.cat([v.flatten().float() for v in d.values()])
    whole = leaf_rel_err(flat(ranks[0]["params"]), flat(params))
    ranks_same = all(torch.equal(ranks[0]["params"][n],
                                 ranks[1]["params"][n]) for n in params)
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(ranks[0]["losses"], want))
    counts = {}
    for r in ranks:
        for delta in r["per_step"]:
            add_counts(counts, delta)
    per_step = [[tuple(d[k] for k in DDP_STEP_KERNELS + ("fused_adam_step",))
                 for d in r["per_step"]] for r in ranks]
    row = {"phase": "ddp", "part": "b_world2_gloo_one_card",
           "nvidia_smi": smi, "rows": list(DDP_ROWS),
           "rank_shapes": [r["shape"] for r in ranks], "steps": steps,
           "losses_rank0": ranks[0]["losses"],
           "losses_rank1": ranks[1]["losses"], "losses_world1": want,
           "max_loss_rel_err": loss_err, "tol_loss": tol["loss"],
           "max_param_rel_err": param_err, "tol_param": tol["grad"],
           "worst_param_leaves": worst, "all_params_rel_err": whole,
           "widened_leaves": {n: {"err": errs[n], "padding_shift": shift[n]}
                              for n in params if bars[n] > tol["grad"]},
           "losses_padded": runs["padded"][0],
           "params_equal_on_ranks": ranks_same,
           "kernel_calls_per_step": per_step}
    row["ok"] = ranks[0]["losses"] == ranks[1]["losses"] and \
        loss_err <= tol["loss"] and all(errs[n] <= bars[n] for n in errs) \
        and \
        ranks_same and all(r["fused"] for r in ranks) and \
        all(c == (18, 18, 32, 1) for rank in per_step for c in rank)
    emit(row)
    if not row["ok"]:
        raise AssertionError("ddp part (b) failed: %s" % row)
    return counts, model, optimizer, scheduler


def pad_time(host, extra):
    """``host`` with ``extra`` more zero bytes and mel frames past every
    row's lengths (padding the masks keep out of every term)."""
    out = dict(host)
    for key in ("inputs", "mel_targets"):
        widths = [(0, 0)] * host[key].ndim
        widths[1] = (0, extra)
        out[key] = np.pad(host[key], widths)
    return out


def checkpoint_host_ms(model, optimizer, scheduler, out_dir, reps=3):
    """The host ms a step spends at a checkpoint (``AsyncCheckpointer.save``
    returns after the host copy; the write runs on its thread): rank 0 of
    a world-2 sharded save beside a single-file save, the flagship state
    after part (b)'s steps, in turns."""
    import shutil
    from few_shot_transformer_tts_torch.train.checkpoint import \
        AsyncCheckpointer
    root = os.path.join(out_dir, "ddp_ckpt")
    ms = {"sharded": [], "single_file": []}
    saver = AsyncCheckpointer()
    for i in range(reps):
        for kind in ms:
            shutil.rmtree(root, ignore_errors=True)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            saver.save(root, model, optimizer, scheduler, i + 1,
                       sharded=kind == "sharded", rank=0, world=2)
            ms[kind].append((time.perf_counter() - tic) * 1e3)
            if not saver.wait():
                raise RuntimeError("checkpoint write failed")
    shutil.rmtree(root, ignore_errors=True)
    return ms


def shard_coverage(ckpt_dir):
    """(file names, each file a proper subset of the leaves, every element
    written once) of a sharded checkpoint directory."""
    import pickle
    names = sorted(os.listdir(ckpt_dir))
    leaves = []
    for name in names:
        with open(os.path.join(ckpt_dir, name), "rb") as f:
            leaves.append(pickle.load(f)["leaves"])
    union = set().union(*(set(l) for l in leaves)) if leaves else set()
    proper = all(0 < len(l) < len(union) for l in leaves)
    once = sum(len(l) for l in leaves) == len(union)
    for l in leaves:
        for key, rec in l.items():
            covered = np.zeros(rec["shape"], np.int64)
            for index, _ in rec["shards"]:
                covered[tuple(index)] += 1
            once = once and bool(np.all(covered == 1))
    return names, proper, once


def ddp_cli(out_dir, seed, smi):
    """Part (c): the train CLI under ``torchrun --nproc_per_node 2
    --multihost --dist_backend gloo`` on the card at phase 10's widths: 2
    steps with a checkpoint at 2, a resume to 4 at world 2, then a world-1
    run (in-process, no --multihost) from model.ckpt-4.d."""
    import shutil
    from few_shot_transformer_tts_torch.train import cli
    root = os.path.join(out_dir, "ddp_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    write_corpus(root, seed)
    models, logs = os.path.join(root, "models"), os.path.join(root, "logs")
    argv = ["--model-dir", models, "--log-dir", logs, "--data-dir", root,
            "--checkpoint_interval", "2", "--summary_interval", "2",
            "--log_interval", "2", "--hparams", CLI_HPARAMS,
            "--seed", str(seed)]
    wall = []
    for steps in (2, 4):
        tic = time.perf_counter()
        with open(os.path.join(root, "torchrun_%d.log" % steps), "w") as log:
            subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "2", "-m",
                 "few_shot_transformer_tts_torch.train", "--multihost",
                 "--dist_backend", "gloo", *argv, "--max_steps", str(steps)],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, check=True,
                timeout=300)
        wall.append(time.perf_counter() - tic)
    shards = {s: shard_coverage(os.path.join(models, "model.ckpt-%d.d" % s))
              for s in (2, 4)}
    with open(os.path.join(root, "torchrun_4.log")) as f:
        resumed = "Restore from previous run" in f.read()
    # the CLI logs to stdout; its lines (and those of the feeder thread
    # that outlives it) go to a file that stays open
    log = open(os.path.join(root, "world1.log"), "w")
    with contextlib.redirect_stdout(log):
        _, step = cli.main(argv + ["--log-dir", os.path.join(root, "logs1"),
                                   "--max_steps", "5"])
    log.flush()
    with open(os.path.join(root, "world1.log")) as f:
        world1_loaded = "model.ckpt-4.d, step 4" in f.read()
    tmp_left = [os.path.join(d, f) for d, _, files in os.walk(root)
                for f in files if f.endswith(".tmp")]
    row = {"phase": "ddp", "part": "c_train_cli_torchrun_gloo",
           "nvidia_smi": smi, "torchrun_wall_s": wall,
           "shards": {s: {"files": v[0], "proper_subsets": v[1],
                          "every_element_once": v[2]}
                      for s, v in shards.items()},
           "feeder_states": sorted(f for f in os.listdir(logs)
                                   if f.startswith("feeder_")),
           "resumed_at_world2": resumed, "world1_loaded_ckpt4": world1_loaded,
           "world1_last_step": step, "tmp_left": tmp_left}
    row["ok"] = all(v[0] == ["shard-0-of-2.pkl", "shard-1-of-2.pkl"] and
                    v[1] and v[2] for v in shards.values()) and \
        row["feeder_states"] == ["feeder_0.pkl", "feeder_1.pkl"] and \
        resumed and world1_loaded and step == 5 and not tmp_left
    emit(row)
    if not row["ok"]:
        raise AssertionError("ddp part (c) failed: %s" % row)


def ddp_phase(out_dir, seed, smi, steps=10):
    """Data-parallel training: (a) world 1 over NCCL against the unwrapped
    step, (b) world 2 over gloo on one card against world 1, the host ms
    of a sharded checkpoint beside a single-file one, (c) the train CLI
    under torchrun.  Returns the launches of the DDP steps of (a) and of
    both ranks of (b): the kernels line's ``ddp`` path."""
    tic = time.perf_counter()
    hp = default_config(transformer_dropout_rate=0.0,
                        decoder_dropout_rate=0.0)
    host = train_batch(hp, seed)
    counts = ddp_world1(hp, host, seed, steps, smi)
    counts_b, model, optimizer, scheduler = ddp_world2(host, seed, out_dir,
                                                       smi)
    add_counts(counts, counts_b)
    ckpt_ms = checkpoint_host_ms(model, optimizer, scheduler, out_dir)
    del model, optimizer, scheduler
    emit({"phase": "ddp", "part": "checkpoint_host_ms", "nvidia_smi": smi,
          "state": "flagship default_config, fused Adam after 3 steps",
          "sharded_rank0_of_2_ms": ckpt_ms["sharded"],
          "single_file_ms": ckpt_ms["single_file"]})
    ddp_cli(out_dir, seed, smi)
    emit({"phase": "ddp", "part": "done", "launches": counts,
          "seconds": time.perf_counter() - tic})
    return {"counts": counts}


# ---------------------------------------------------------------------------
# phase 17: remat (activation checkpointing of the attention and FFN calls)
# ---------------------------------------------------------------------------

REMAT_KERNELS = ("mha_forward", "mha_backward", "layer_norm_backward")


def remat_run(hp, state, batch, seed, steps):
    """``steps`` steps from ``state`` (the first one's generator for every
    comparison): the first step's loss and gradients, the launches of each
    step, each step's seconds, and the peak memory of a steady step (reset
    after the first, which allocates Adam's moments)."""
    model = ByteToMel(hp, device="cuda")
    model.load_state_dict(state)
    optimizer, scheduler = make_optimizer(model, hp)
    per_step, times, loss, grads, peak = [], [], None, None, None
    for step in range(steps):
        if step == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        tic = time.perf_counter()
        out = train_step(model, optimizer, scheduler, batch, hp,
                         step_generator(seed, step, "cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - tic)
        per_step.append(count_delta(before))
        if step == 0:
            loss = float(out["loss"])
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
        if step == 1:
            peak = torch.cuda.max_memory_allocated()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, optimizer
    return {"loss": loss, "grads": grads, "per_step": per_step,
            "times": times, "peak": peak, "params": params}


def remat_phase(seed, smi, steps=10):
    """``hp.remat`` at the flagship (bf16, B=16, T_in 192, T_out 448,
    dropout 0.1, one generator a step): ``steps`` steps with remat off and
    on from the same weights; the first step's loss and gradients held to
    TOL_STEP (and counted where they are bit for bit), the peak memory of a
    steady step, the median sec/step of steps 3-10, the launches a step
    (the remat step runs each attention forward twice); then one step of
    each with ``use_fused_adam``, parameters after it held to TOL_STEP's
    gradient bar."""
    tic = time.perf_counter()
    hp = default_config()
    batch = device_batch(train_batch(hp, seed), hp, "cuda")
    state = init_weights_(ByteToMel(hp, device="cuda"), seed).state_dict()
    counts = dict(NO_LAUNCHES)
    runs = {}
    for remat in (False, True):
        runs[remat] = remat_run(hp.replace(remat=remat), state, batch, seed,
                                steps)
        if remat:
            for delta in runs[remat]["per_step"]:
                add_counts(counts, delta)
    off, on = runs[False], runs[True]
    tol = TOL_STEP[torch.bfloat16]
    loss_err = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    errs = {n: leaf_rel_err(on["grads"][n], g)
            for n, g in off["grads"].items()}
    same = sum(torch.equal(on["grads"][n], g) for n, g in off["grads"].items())
    max_abs = max(float((on["grads"][n] - g).abs().max())
                  for n, g in off["grads"].items())
    fused = {}
    for remat in (False, True):
        fused[remat] = remat_run(hp.replace(remat=remat, use_fused_adam=True),
                                 state, batch, seed, 1)
        if remat:
            add_counts(counts, fused[remat]["per_step"][0])
    fused_errs = {n: leaf_rel_err(fused[True]["params"][n], p)
                  for n, p in fused[False]["params"].items()}
    launches = lambda run: [tuple(d[k] for k in REMAT_KERNELS)
                            for d in run["per_step"]]
    sec = {k: float(np.median(runs[k]["times"][2:])) for k in runs}
    row = {"phase": "remat", "nvidia_smi": smi,
           "config": "default_config (flagship), bf16, dropout 0.1",
           "B": 16, "T_in": 192, "T_out": 448,
           "loss_off": off["loss"], "loss_on": on["loss"],
           "loss_rel_err": loss_err, "tol_loss": tol["loss"],
           "max_grad_rel_err": max(errs.values()), "tol_grad": tol["grad"],
           "max_grad_abs_diff": max_abs,
           "bit_identical_grad_leaves": [same, len(errs)],
           "peak_mem_gb_off": off["peak"] / 2 ** 30,
           "peak_mem_gb_on": on["peak"] / 2 ** 30,
           "peak_mem_drop": 1 - on["peak"] / off["peak"],
           "sec_per_step_off": sec[False], "sec_per_step_on": sec[True],
           "on_over_off": sec[True] / sec[False],
           "step_s_off": off["times"], "step_s_on": on["times"],
           "launches_per_step_off": launches(off),
           "launches_per_step_on": launches(on),
           "fused_adam_launches": [fused[k]["per_step"][0]["fused_adam_step"]
                                   for k in (False, True)],
           "fused_adam_max_param_rel_err": max(fused_errs.values()),
           "seconds": time.perf_counter() - tic}
    row["ok"] = loss_err <= tol["loss"] and \
        max(errs.values()) <= tol["grad"] and \
        all(c == (18, 18, 32) for c in launches(off)) and \
        all(c == (36, 18, 32) for c in launches(on)) and \
        on["peak"] < off["peak"] and \
        row["fused_adam_launches"] == [1, 1] and \
        max(fused_errs.values()) <= tol["grad"]
    emit(row)
    if not row["ok"]:
        raise AssertionError("remat phase failed: %s" % row)
    return {"counts": counts}


# ---------------------------------------------------------------------------
# phase 18: the runtime (profiler flags, host mirror, native zip reader)
# ---------------------------------------------------------------------------

# phase 10's widths, with a prenet of 1024: its [1024, 1024] layer is a
# fused Adam kernel leaf, so a use_fused_adam step launches the kernel
RUNTIME_HPARAMS = CLI_HPARAMS.replace(
    "prenet_hidden=64", "prenet_hidden=1024") + ",use_fused_adam=True"
TRACE_KERNELS = ("mha_fwd", "mha_bwd", "ln_bwd_kernel", "adam_leaves_kernel")


STEP_PARTS = ("train.backward", "train.forward", "train.optimizer")


def trace_names(path):
    """(kernel names, for each ``train.step`` range the step parts'
    ranges it holds on its thread) of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    spans = [sorted({e["name"] for e in ranges
                     if e["name"] in STEP_PARTS and e["tid"] == s["tid"] and
                     s["ts"] <= e["ts"] and
                     e["ts"] + e["dur"] <= s["ts"] + s["dur"]})
             for s in ranges if s["name"] == "train.step"]
    return kernels, spans


def runtime_cli(out_dir, seed, smi):
    """The train CLI at phase 10's widths on a mels.zip corpus: a profiled
    window, then a forced crash in the optimizer step with the host mirror
    every 2 steps, and a resume from the crash checkpoint."""
    import glob
    import shutil
    from few_shot_transformer_tts_torch.data.zipstore import load_zip
    from few_shot_transformer_tts_torch.ops import fused_adam as adam_ops
    from few_shot_transformer_tts_torch.train import cli
    from few_shot_transformer_tts_torch.train.loop import StateUpdateError
    root = os.path.join(out_dir, "runtime")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    write_corpus(root, seed)
    trace_dir = os.path.join(root, "trace")

    def argv(run, *extra):
        return ["--model-dir", os.path.join(root, run, "models"),
                "--log-dir", os.path.join(root, run, "logs"),
                "--data-dir", root, "--checkpoint_interval", "100",
                "--summary_interval", "100", "--log_interval", "2",
                "--eval_steps", "100", "--hparams", RUNTIME_HPARAMS,
                "--seed", str(seed), *extra]
    log = open(os.path.join(root, "runtime_cli.log"), "w")
    before = read_counts()
    with contextlib.redirect_stdout(log):
        cli.main(argv("prof", "--max_steps", "6", "--profile_dir", trace_dir,
                      "--profile_step", "3", "--profile_n_steps", "2"))
        # a fault inside the optimizer step of step 5, after the kernel
        # leaves took their update: the live state is half-updated
        plain, step_fn, steps = adam_ops.adam_leaf_plain, FusedAdam.step, []

        def counted_step(self, *args, **kwargs):
            steps.append(1)
            return step_fn(self, *args, **kwargs)

        def faulty(*args):
            if len(steps) == 5:
                raise RuntimeError("fault injected into the optimizer step")
            return plain(*args)
        adam_ops.adam_leaf_plain, FusedAdam.step = faulty, counted_step
        crashed = False
        try:
            cli.main(argv("crash", "--max_steps", "8", "--mirror_interval",
                          "2"))
        except StateUpdateError:
            crashed = True
        finally:
            adam_ops.adam_leaf_plain, FusedAdam.step = plain, step_fn
        crash_ckpts = sorted(os.listdir(os.path.join(root, "crash",
                                                     "models")))
        _, resumed = cli.main(argv("crash", "--max_steps", "6",
                                   "--mirror_interval", "2"))
    log.flush()
    counts = count_delta(before)
    traces = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) \
        else []
    kernels, spans = trace_names(os.path.join(trace_dir, traces[0])) \
        if traces else (set(), [])
    crash_log = "".join(open(p).read() for p in glob.glob(
        os.path.join(root, "crash", "logs", "outputs_*.log")))
    store = load_zip(os.path.join(root, "mels.zip"))
    row = {"phase": "runtime", "part": "train_cli", "nvidia_smi": smi,
           "hparams": RUNTIME_HPARAMS, "traces": traces, "trace_spans": spans,
           "trace_kernels": {k: sorted(n for n in kernels if k in n)[:3]
                             for k in TRACE_KERNELS},
           "crashed": crashed, "crash_checkpoints": crash_ckpts,
           "fell_back_to_mirror": "falling back to the host mirror"
           in crash_log, "resumed_from_4": "step 4" in crash_log and
           "Restore from previous run" in crash_log,
           "resumed_to": resumed, "kernel_calls": counts,
           "store_native": store._native is not None,
           "store_native_reads": store.native_reads,
           "store_zipfile_reads": store.zipfile_reads}
    row["ok"] = traces == ["trace_rank0_steps3-4.json"] and \
        spans == [list(STEP_PARTS)] * 2 and \
        all(row["trace_kernels"].values()) and crashed and \
        crash_ckpts == ["model.ckpt-4"] and row["fell_back_to_mirror"] and \
        row["resumed_from_4"] and resumed == 6 and row["store_native"] and \
        store.native_reads > 0 and store.zipfile_reads == 0 and \
        counts["fused_adam_step"] > 0
    emit(row)
    if not row["ok"]:
        raise AssertionError("runtime phase (CLI) failed: %s" % row)
    return counts


FEEDER_ENTRIES = 2000
FEEDER_STEPS = 20


def write_flagship_mels(root, seed, hp, n=FEEDER_ENTRIES, frames=448):
    """A mels.zip of ``n`` flagship-size mels ([448, 80] fp32, stored),
    metadata rows of 100-180 bytes of text over 2 languages, id maps."""
    import io
    import zipfile
    rng = np.random.RandomState(seed + 7)
    rows = []
    mel = np.clip(rng.randn(frames, hp.num_mels), -4, 4).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, mel)
    with zipfile.ZipFile(os.path.join(root, "mels.zip"), "w") as zf:
        for i in range(n):
            lang = ("en-us", "de-de")[i % 2]
            name = "%s0_%010d" % (lang[:2], i)
            zf.writestr(name + ".npy", buf.getvalue())
            text = " ".join(CORPUS_WORDS[j] for j in rng.randint(
                0, len(CORPUS_WORDS), 40))
            text = text[:int(rng.randint(100, 181))]
            rows.append("%s.npy|%d|%s|%s" % (name, frames, text, lang))
    with open(os.path.join(root, "metadata.train.txt"), "w") as f:
        f.write("\n".join(rows))
    return {"en-us": 0, "de-de": 1}, {"en0": 0, "de0": 1}


def read_rate(path, names, threads, native):
    """Entries a second that ``threads`` threads read through one
    ``ZipStore`` (native reader, or zipfile alone), each its share."""
    from concurrent.futures import ThreadPoolExecutor
    from few_shot_transformer_tts_torch.data.zipstore import ZipStore
    store = ZipStore(path)
    if not native:
        store._native = None
    parts = [names[t::threads] for t in range(threads)]
    tic = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(lambda part: [store.read_npy(n) for n in part], parts))
    return len(names) / (time.perf_counter() - tic)


def feeder_measurement(out_dir, seed, smi):
    """The Feeder at the flagship lattice against the flagship train step:
    its queue depth before each of FEEDER_STEPS steps, the seconds the step
    waited for a batch, and the read rate of its store, native against
    zipfile (the archive was just written: the page cache holds it)."""
    import shutil
    from few_shot_transformer_tts_torch.data import Feeder
    root = os.path.join(out_dir, "feeder")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # no data warm-up: it admits mid-length targets only, not 448 frames
    hp = default_config(data_warmup_steps=0)
    tic = time.perf_counter()
    lang_to_id, spk_to_id = write_flagship_mels(root, seed, hp)
    write_s = time.perf_counter() - tic
    path = os.path.join(root, "mels.zip")
    names = ["%s0_%010d.npy" % (("en", "de")[i % 2], i)
             for i in range(FEEDER_ENTRIES)]
    rates = {}
    for native in (True, False, True, False):
        for threads in (1, 4):
            key = "%s_%d_threads" % ("native" if native else "zipfile",
                                     threads)
            rates.setdefault(key, []).append(
                read_rate(path, names, threads, native))
    feeder = Feeder(path, os.path.join(root, "metadata.train.txt"),
                    hparams=hp, spk_to_id=spk_to_id, lang_to_id=lang_to_id)
    model = init_weights_(ByteToMel(hp, device="cuda"), seed)
    optimizer, scheduler = make_optimizer(model, hp)
    tic = time.perf_counter()
    feeder.start()
    batch = feeder.get_batch()
    first_s = time.perf_counter() - tic
    depth, waits, times, shapes = [], [], [], []
    for step in range(FEEDER_STEPS):
        dbatch = device_batch(batch, hp, "cuda")
        shapes.append(list(batch["mel_targets"].shape[:2]))
        tic = time.perf_counter()
        train_step(model, optimizer, scheduler, dbatch, hp,
                   step_generator(seed, step, "cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - tic)
        depth.append(feeder.queue.qsize())
        tic = time.perf_counter()
        batch = feeder.get_batch()
        waits.append(time.perf_counter() - tic)
    del model, optimizer
    row = {"phase": "runtime", "part": "feeder", "nvidia_smi": smi,
           "entries": FEEDER_ENTRIES, "mel_shape": [448, hp.num_mels],
           "zip_mb": os.path.getsize(path) / 2 ** 20, "write_s": write_s,
           "entries_per_s": rates,
           "native_over_zipfile_4_threads": float(
               np.median(rates["native_4_threads"]) /
               np.median(rates["zipfile_4_threads"])),
           "first_batch_s": first_s, "queue_depth_before_step": depth,
           "get_batch_wait_s": waits, "step_s": times,
           "batch_shapes": shapes[:3],
           "store_native_reads": feeder.zfile.native_reads,
           "store_zipfile_reads": feeder.zfile.zipfile_reads,
           "keeps_ahead": min(depth) > 0}
    row["ok"] = feeder.zfile.native_reads > 0 and \
        feeder.zfile.zipfile_reads == 0 and all(np.isfinite(times))
    emit(row)
    if not row["ok"]:
        raise AssertionError("runtime phase (feeder) failed: %s" % row)


def runtime_phase(out_dir, seed, smi):
    """The rest of the training runtime: the train CLI's profiler flags,
    host mirror and crash save, its store on the native reader, and the
    Feeder against the flagship step."""
    tic = time.perf_counter()
    counts = runtime_cli(out_dir, seed, smi)
    feeder_measurement(out_dir, seed, smi)
    emit({"phase": "runtime", "part": "done", "launches": counts,
          "seconds": time.perf_counter() - tic})
    return {"counts": counts}


# ---------------------------------------------------------------------------
# phase 19: tensor parallelism over the model axis
# ---------------------------------------------------------------------------

TP_STEPS = 3
TP_RATES = (0.0, 0.1)


def tp_hparams(rate):
    return default_config(transformer_dropout_rate=rate,
                          decoder_dropout_rate=rate, use_fused_adam=True)


def tp_rank(rank, port, seed, out_dir):
    """One rank of the ``(data=1, model=2)`` grid (a spawned process, gloo,
    both ranks on cuda:0): the flagship split over the model axis, TP_STEPS
    steps at each of TP_RATES with fused Adam; the heads its attention
    calls ran on; its parameters, and its shard file of a TP checkpoint;
    the shapes of the split products of its first step at rate 0."""
    from few_shot_transformer_tts_torch.models import common
    from few_shot_transformer_tts_torch.parallel import mesh
    from few_shot_transformer_tts_torch.parallel.sharding_rules import \
        shard_model_
    from few_shot_transformer_tts_torch.train import checkpoint as ckpt
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://localhost:%d" % port, rank=rank,
        world_size=2)
    try:
        grid = mesh.make_grid(2)
        # the heads, head offset and width of every attention kernel call
        seen = []
        apply = mha_ops.MhaFunction.apply

        def recorded(q, k, v, bias, seed, num_heads, causal, scale,
                     use_bias, rate, head_offset=0):
            seen.append((num_heads, head_offset, q.shape[-1]))
            return apply(q, k, v, bias, seed, num_heads, causal, scale,
                         use_bias, rate, head_offset)
        mha_ops.MhaFunction.apply = recorded
        products = []
        row_apply = common._PartialProduct.apply
        col_apply = common._ColumnParallel.apply

        def row_recorded(x, weight):
            products.append(("row", tuple(x.shape), tuple(weight.shape)))
            return row_apply(x, weight)

        def col_recorded(x, weight, group):
            products.append(("column", tuple(x.shape), tuple(weight.shape)))
            return col_apply(x, weight, group)
        common._PartialProduct.apply = row_recorded
        common._ColumnParallel.apply = col_recorded
        result = {}
        for rate in TP_RATES:
            hp = tp_hparams(rate)
            model = init_weights_(ByteToMel(hp, device="cuda"), seed)
            whole = shard_model_(model, grid.model_rank, grid.model,
                                 grid.model_group)
            optimizer, scheduler = make_optimizer(model, hp)
            batch = device_batch(train_batch(hp, seed), hp, "cuda")
            losses, per_step, times, grads = [], [], [], None
            reset_counts()
            for step in range(TP_STEPS):
                before = read_counts()
                del seen[:]
                tic = time.perf_counter()
                out = train_step(model, optimizer, scheduler, batch, hp,
                                 step_generator(seed, step, "cuda",
                                                grid.data_rank),
                                 grid.stats_group)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - tic)
                losses.append(float(out["loss"]))
                per_step.append(count_delta(before))
                if step == 0:
                    grads = {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()}
                    result.setdefault("products", list(products))
            result[rate] = {
                "losses": losses, "per_step": per_step, "step_s": times,
                "grads": grads,
                "heads_seen": sorted(set(seen)), "whole": whole,
                "params": {n: p.detach().cpu() for n, p in
                           model.named_parameters()},
                "specs": {n: (p.tp.dim, [(r.start, r.stop)
                                         for r in p.tp.ranges],
                              p.tp.full_shape)
                          for n, p in model.named_parameters()
                          if hasattr(p, "tp")}}
            if rate == 0.0:
                shards = ckpt.snapshot_local_shards(model, optimizer,
                                                    TP_STEPS, rank, 2, grid)
                ckpt.save_state_sharded(os.path.join(out_dir, "ckpt"),
                                        shards, TP_STEPS, rank, 2)
            del model, optimizer
        mha_ops.MhaFunction.apply = apply
        common._PartialProduct.apply = row_apply
        common._ColumnParallel.apply = col_apply
        torch.save(result, os.path.join(out_dir, "rank%d.pt" % rank))
    finally:
        torch.distributed.destroy_process_group()


def tp_gather(ranks, name, key="params"):
    """The whole parameter ``name`` (or, with ``key="grads"``, its first
    step's gradient) from the two ranks' parts."""
    spec = ranks[0]["specs"].get(name)
    if spec is None:
        return ranks[0][key][name]
    dim, _, full = spec
    out = torch.zeros(full)
    for r in ranks:
        at = 0
        for start, stop in r["specs"][name][1]:
            index = [slice(None)] * len(full)
            index[dim] = slice(start, stop)
            out[tuple(index)] = r[key][name].narrow(dim, at, stop - start)
            at += stop - start
    return out


def tp_coverage(ckpt_dir):
    """(file names, each file a proper subset of the state's elements,
    every element written once) of a TP sharded checkpoint."""
    import pickle
    names = sorted(os.listdir(ckpt_dir))
    files, covered, sizes = [], {}, []
    for name in names:
        with open(os.path.join(ckpt_dir, name), "rb") as f:
            leaves = pickle.load(f)["leaves"]
        n = 0
        for key, rec in leaves.items():
            cov = covered.setdefault(key, np.zeros(rec["shape"], np.int64))
            for index, data in rec["shards"]:
                cov[tuple(index)] += 1
                n += int(np.asarray(data).size)
        sizes.append(n)
    total = sum(c.size for c in covered.values())
    return names, all(0 < n < total for n in sizes), \
        all(np.all(c == 1) for c in covered.values())


def tp_head_offset_check(seed):
    """The attention kernels on a rank's 4 heads (head offset 4) at the
    decoder's causal train shape, rate 0.1: bit for bit the same heads of
    the 8-head call, and within TOL_TRAIN of the plain version with the
    same offset."""
    rng = np.random.RandomState(seed + 11)
    b, t, c, heads = 16, 448, 768, 8
    q, k, v = (torch.from_numpy(rng.randn(b, t, c).astype(np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    do = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    seed_t = torch.tensor([seed + 12345], dtype=torch.int64, device="cuda")
    scale = 96 ** -0.5
    o, lse = mha_forward(q, k, v, None, heads, True, scale, False, 0.1,
                         seed_t)
    grads = mha_backward(q, k, v, None, seed_t, o, lse, do, heads, True,
                         scale, False, 0.1)
    cols = slice(c // 2, c)
    part = [t_[..., cols].contiguous() for t_ in (q, k, v, do)]
    o4, lse4 = mha_forward(*part[:3], None, 4, True, scale, False, 0.1,
                           seed_t, 4)
    grads4 = mha_backward(*part[:3], None, seed_t, o4, lse4, part[3], 4,
                          True, scale, False, 0.1, 4)
    same = torch.equal(o4, o[..., cols]) and \
        torch.equal(lse4, lse[..., 4:]) and \
        all(torch.equal(g4, g[..., cols]) for g4, g in zip(grads4, grads))
    o_plain, _ = mha_forward_plain(*part[:3], None, 4, True, scale, False,
                                   0.1, seed_t, 4)
    g_plain = mha_backward_plain(*part[:3], None, seed_t, o4, lse4, part[3],
                                 4, True, scale, False, 0.1, 4)
    err = max([rel_err(o4, o_plain)] +
              [rel_err(g, gp) for g, gp in zip(grads4, g_plain)])
    return {"same_bits_as_the_8_head_call": same, "max_err": err,
            "tol": TOL_TRAIN[torch.bfloat16]}


def tp_product_ms(products, iters=3):
    """Device ms of one rank's split products in one TP step, at the shapes
    its first step recorded (``products``: kind, x's shape, the weight's),
    without the all-reduces, three ways: the row-parallel product forward
    and backward, and the column-parallel input gradient (with its weight
    gradient, the same each way), as (a) bf16 products with an fp32 result
    (``models/common.py``), (b) fp32 products of inputs upcast from bf16
    (the form this replaced: no tensor cores) and (c) bf16 products
    rounded to bf16 before the fp32 sum (one more rounding a partial).
    Few iterations, so the sleep kernel of ``cuda_ms`` outlasts the host's
    queueing and the events time the card."""
    from few_shot_transformer_tts_torch.models import common
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    bf16 = torch.bfloat16
    cases = []
    for kind, xs, ws in products:
        m, k, n = int(np.prod(xs[:-1])), xs[-1], ws[0]
        x = torch.randn(m, k, device="cuda", generator=gen).to(bf16)
        w = torch.randn(n, k, device="cuda", generator=gen)
        g = torch.randn(m, n, device="cuda", generator=gen)
        cases.append((kind, x.requires_grad_(), w.requires_grad_(),
                      g if kind == "row" else g.to(bf16)))

    def run(way):
        for kind, x, w, g in cases:
            if kind == "column":
                wb = w.detach().to(bf16)
                if way == "fp32_out":
                    common._mm_fp32(g, wb)
                elif way == "fp32":
                    torch.mm(g.float(), wb.float()).to(bf16)
                else:
                    torch.mm(g, wb).float()
                torch.mm(g.t(), x.detach())
                continue
            if way == "fp32_out":
                out = common._PartialProduct.apply(x, w)
            elif way == "fp32":
                out = F.linear(x.float(), w.to(bf16).float())
            else:
                out = F.linear(x, w.to(bf16)).float()
            out.backward(g)
    return {way: cuda_ms(lambda: run(way), iters)
            for way in ("fp32_out", "fp32", "bf16")}


def tp_phase(out_dir, seed, smi):
    """Tensor parallelism at the flagship (bf16, phase 9's batch): two
    spawned ranks over gloo on cuda:0 (one card cannot host two NCCL
    ranks), grid data=1, model=2, TP_STEPS steps with fused Adam at dropout
    0 and 0.1, against world 1 in this process; a TP checkpoint loaded at
    world 1.  Gloo through the host is no scaling number: no time of it is
    kept as one."""
    import shutil
    tic = time.perf_counter()
    root = os.path.join(out_dir, "tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    offset_check = tp_head_offset_check(seed)
    torch.multiprocessing.start_processes(
        tp_rank, args=(free_port(), seed, root), nprocs=2,
        start_method="spawn")
    ranks = [torch.load(os.path.join(root, "rank%d.pt" % r),
                        weights_only=False) for r in range(2)]
    products = ranks[0]["products"]
    product_ms = tp_product_ms(products)
    emit({"phase": "tp", "part": "split_products", "nvidia_smi": smi,
          "products_per_step": len(products),
          "row": sum(kind == "row" for kind, _, _ in products),
          "ms_per_step_bf16_fp32_out": product_ms["fp32_out"],
          "ms_per_step_fp32": product_ms["fp32"],
          "ms_per_step_bf16_partials": product_ms["bf16"]})
    host = train_batch(tp_hparams(0.0), seed)
    state = init_weights_(ByteToMel(tp_hparams(0.0), device="cuda"),
                          seed).state_dict()
    reversed_rows = {k: np.ascontiguousarray(v[::-1])
                     for k, v in host.items()}
    tol = TOL_STEP[torch.bfloat16]
    counts = dict(NO_LAUNCHES)
    rows = {}
    for rate in TP_RATES:
        hp = tp_hparams(rate)
        # the same step computed with other roundings, each drawing this
        # rate's dropout masks: the plain versions of the attention kernels
        # (the kernels' own Philox masks), of the LayerNorm backward, and
        # of both, in their place (train_step_agreement's pairs), and, at
        # dropout 0 only (both move the masks), the batch padded by 8
        # masked frames and bytes (ddp (b)'s bar) and its rows reversed
        plain_ln = hp.replace(use_fused_layernorm=False)
        runs = [("world1", hp, host, False),
                ("plain_attention", hp, host, True),
                ("plain_ln", plain_ln, host, False),
                ("plain_both", plain_ln, host, True)]
        if rate == 0.0:
            runs += [("padded", hp, pad_time(host, 8), False),
                     ("reversed", hp, reversed_rows, False)]
        world1 = {}
        for kind, hp_k, batch, plain_attention in runs:
            model = ByteToMel(hp_k, device="cuda")
            model.load_state_dict(state)
            optimizer, scheduler = make_optimizer(model, hp_k)
            dbatch = device_batch(batch, hp, "cuda")
            losses, grads = [], None
            if plain_attention:
                mha_ops.mha_forward = mha_forward_plain
                mha_ops.mha_backward = mha_backward_plain
            try:
                for step in range(TP_STEPS):
                    losses.append(float(train_step(
                        model, optimizer, scheduler, dbatch, hp_k,
                        step_generator(seed, step, "cuda"))["loss"]))
                    if step == 0:
                        grads = {n: p.grad.detach().cpu()
                                 for n, p in model.named_parameters()}
            finally:
                mha_ops.mha_forward, mha_ops.mha_backward = \
                    mha_forward, mha_backward
            world1[kind] = (losses, {n: p.detach().cpu() for n, p in
                                     model.named_parameters()}, model,
                            optimizer, scheduler, grads)
        want, params = world1["world1"][:2]
        rs = [r[rate] for r in ranks]
        g1 = world1["world1"][5]
        swaps = [k for k, _, _, _ in runs[1:]]
        # each first-step gradient leaf against world 1, to TOL_STEP's bar
        # or to twice the farthest a swap moves it, where that is wider: a
        # leaf that one scalar sum cancels (the encoder's pe_scale, see
        # TOL_STEP) moves by a large share under any other rounding
        grad_errs = {n: leaf_rel_err(tp_gather(rs, n, "grads"), g)
                     for n, g in g1.items()}
        grad_bars = {n: max([tol["grad"]] + [
            2 * leaf_rel_err(world1[k][5][n], g) for k in swaps])
            for n, g in g1.items()}
        # each first-step gradient element's rounding noise: the farthest
        # those swaps move it.  An element inside it (Adam turns its noise
        # into a +-lr step) is held through its first-step gradient above,
        # as tests/test_torch_ddp.py holds the noise floor; the elements
        # clear of it are held, leaf by leaf, to TOL_STEP's bar or to twice
        # the farthest a swap moves them after the steps, where that is
        # wider (ddp (b)'s padding bar, over every swap)
        clear = {n: g.abs() > 4 * torch.stack(
            [(world1[k][5][n] - g).abs() for k in swaps]).amax(0)
            for n, g in g1.items()}
        gathered = {n: tp_gather(rs, n) for n in params}
        on_clear = lambda a, n: a[clear[n]] if clear[n].any() else a[:0]
        errs, bars = {}, {}
        for n in params:
            want_n = on_clear(params[n], n)
            if not want_n.numel():
                errs[n], bars[n] = 0.0, tol["grad"]
                continue
            errs[n] = leaf_rel_err(on_clear(gathered[n], n), want_n)
            bars[n] = max([tol["grad"]] + [
                2 * leaf_rel_err(on_clear(world1[k][1][n], n), want_n)
                for k in swaps])
        whole_errs = {n: leaf_rel_err(gathered[n], params[n])
                      for n in params}
        held = sum(int(c.sum()) for c in clear.values()) / \
            sum(c.numel() for c in clear.values())
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(rs[0]["losses"], want))
        for r in rs:
            for delta in r["per_step"]:
                add_counts(counts, delta)
        per_step = [[tuple(d[k] for k in DDP_STEP_KERNELS +
                           ("fused_adam_step",)) for d in r["per_step"]]
                    for r in rs]
        worst = sorted(errs, key=lambda n: errs[n] / bars[n])[-5:]
        worst_grad = sorted(grad_errs,
                            key=lambda n: grad_errs[n] / grad_bars[n])[-3:]
        row = {"phase": "tp", "part": "steps_rate_%g" % rate,
               "nvidia_smi": smi, "grid": "data=1, model=2 (gloo, cuda:0)",
               "steps": TP_STEPS, "losses_rank0": rs[0]["losses"],
               "losses_rank1": rs[1]["losses"], "losses_world1": want,
               "max_loss_rel_err": loss_err, "tol_loss": tol["loss"],
               "max_first_grad_rel_err": max(grad_errs.values()),
               "worst_first_grad_leaf": max(grad_errs, key=grad_errs.get),
               "tol_grad": tol["grad"],
               "worst_first_grad_leaves": [(n, grad_errs[n], grad_bars[n])
                                           for n in worst_grad],
               "widened_grad_leaves": sum(b > tol["grad"]
                                          for b in grad_bars.values()),
               "max_param_rel_err_clear": max(errs.values()),
               "tol_param": tol["grad"],
               "share_clear": held, "min_share_clear": 0.75,
               "worst_param_leaves_clear": [(n, errs[n], bars[n])
                                            for n in worst],
               "widened_leaves": sum(bars[n] > tol["grad"] for n in bars),
               "worst_param_leaves_whole": sorted(
                   whole_errs.items(), key=lambda kv: kv[1])[-5:],
               "losses_plain_both": world1["plain_both"][0],
               "split_leaves": len(rs[0]["specs"]),
               "layers_left_whole": rs[0]["whole"],
               "heads_seen": [r["heads_seen"] for r in rs],
               "kernel_calls_per_step": per_step,
               "gloo_step_s_rank0": rs[0]["step_s"]}
        # the numbers, and apart from them the split the ranks ran
        row["numerics_ok"] = rs[0]["losses"] == rs[1]["losses"] and \
            loss_err <= tol["loss"] and \
            all(grad_errs[n] <= grad_bars[n] for n in grad_errs) and \
            all(errs[n] <= bars[n] for n in errs) and held >= 0.75
        row["layout_ok"] = not rs[0]["whole"] and \
            all({h for h, _, _ in r["heads_seen"]} == {4} and
                {o for _, o, _ in r["heads_seen"]} == {4 * m}
                for m, r in enumerate(rs)) and \
            all(c == (18, 18, 32, 1) for rank in per_step for c in rank)
        row["ok"] = row["numerics_ok"] and row["layout_ok"]
        rows[rate] = row
        emit(row)
        if rate == 0.0:
            _, _, model, optimizer, scheduler, _ = world1["world1"]
            ckpt_dir = os.path.join(root, "ckpt", "model.ckpt-%d.d"
                                    % TP_STEPS)
            names, proper, once = tp_coverage(ckpt_dir)
            step = load_state(ckpt_dir, model, optimizer, scheduler)
            loaded = all(torch.equal(p.detach().cpu(), tp_gather(rs, n))
                         for n, p in model.named_parameters())
            next_loss = float(train_step(
                model, optimizer, scheduler, device_batch(host, hp, "cuda"),
                hp, step_generator(seed, step, "cuda"))["loss"])
            ck = {"phase": "tp", "part": "checkpoint", "nvidia_smi": smi,
                  "files": names, "proper_subsets": proper,
                  "every_element_once": once, "world1_loaded_step": step,
                  "world1_params_equal_gathered": loaded,
                  "world1_next_loss": next_loss}
            ck["ok"] = names == ["shard-0-of-2.pkl", "shard-1-of-2.pkl"] \
                and proper and once and step == TP_STEPS and loaded and \
                bool(np.isfinite(next_loss))
            emit(ck)
            if not ck["ok"]:
                raise AssertionError("tp checkpoint failed: %s" % ck)
        del world1
    failed = [row for row in rows.values() if not row["ok"]]
    if failed:
        raise AssertionError("tp phase failed: %s" % failed)
    done = {"phase": "tp", "part": "head_offset_kernels", "nvidia_smi": smi,
            **offset_check}
    done["ok"] = offset_check["same_bits_as_the_8_head_call"] and \
        offset_check["max_err"] <= offset_check["tol"]
    emit(done)
    if not done["ok"]:
        raise AssertionError("tp head offset check failed: %s" % done)
    shutil.rmtree(root)
    emit({"phase": "tp", "part": "done", "launches": counts,
          "seconds": time.perf_counter() - tic})
    return {"counts": counts}


KERNEL_SOURCES = {
    "mha_forward": ("few_shot_transformer_tts_torch/csrc/mha_fwd.cu",
                    "few_shot_transformer_tts_tpu/ops/"
                    "pallas_attention_train.py:421"),
    "mha_backward": ("few_shot_transformer_tts_torch/csrc/mha_bwd.cu",
                     "few_shot_transformer_tts_tpu/ops/"
                     "pallas_attention_train.py:484"),
    "layer_norm_backward": ("few_shot_transformer_tts_torch/csrc/"
                            "layernorm_bwd.cu",
                            "few_shot_transformer_tts_tpu/ops/"
                            "fused_layernorm.py:126"),
    "decoder_frame_step": ("few_shot_transformer_tts_torch/csrc/"
                           "decoder_step.cu",
                           "few_shot_transformer_tts_tpu/ops/"
                           "pallas_decode.py:346"),
    "fused_frame_mel": ("few_shot_transformer_tts_torch/csrc/frame_mel.cu",
                        "few_shot_transformer_tts_tpu/ops/"
                        "mel_pallas.py:125"),
    "fused_adam_step": ("few_shot_transformer_tts_torch/csrc/fused_adam.cu",
                        "few_shot_transformer_tts_tpu/ops/fused_adam.py:88"),
}


def kernel_line(name, row, err, launches, by_path, **extra):
    source, replaces = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], **extra}


PHASES = ("kernel_check", "train_kernel_check", "ln_kernel_check",
          "head_dim_check",
          "decode_kernel_check",
          "dsp_kernel_check", "adam_kernel_check", "main_path",
          "main_path_fused", "vocode", "cli", "eval_service", "train",
          "train_fused_adam", "train_cli", "corpus", "converge", "ddp",
          "remat", "runtime", "tp")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out-dir",
                        default=os.path.join(ROOT, "build", "chip_smoke"))
    parser.add_argument("--phases", default="all",
                        help="comma-separated subset of %s (debugging; "
                             "the kernels and ok lines need all)"
                             % ",".join(PHASES))
    parser.add_argument("--parent-decoder", default=None,
                        help="a parent commit's csrc/decoder_step.cu: "
                             "decode_kernel_check then times it against "
                             "this one in one call (A/B)")
    parser.add_argument("--parent-wide", default=None,
                        help="a parent commit's csrc/mha_wide.cu: "
                             "head_dim_check then times it against this "
                             "one at the wide train shapes in one call "
                             "(A/B)")
    parser.add_argument("--parent-ln", default=None,
                        help="a parent commit's csrc/layernorm_bwd.cu: "
                             "ln_kernel_check then times it against this "
                             "one at the two train shapes in one call "
                             "(A/B)")
    args = parser.parse_args()
    script_tic = time.perf_counter()
    phases = PHASES if args.phases == "all" else args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error("unknown phases %s" % unknown)

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

    # phase 2: build every source at once
    tic = time.perf_counter()
    # every attention instantiation (one library per head dim), so that
    # each run records every one's registers and spills
    libs = cuda_build.build_all()
    build_s = time.perf_counter() - tic
    ptxas = {}
    for key, lib in libs.items():
        log = lib.with_suffix(".log")
        name = key if isinstance(key, str) else "%s-d%d" % key
        ptxas[name] = [l.strip() for l in log.read_text().splitlines()
                       if "registers" in l or "spill" in l or
                       "Compiling entry" in l] if log.exists() else []
    emit({"phase": "build", "libraries": sorted(ptxas), "seconds": build_s,
          "ptxas": ptxas})

    out = {}
    if "kernel_check" in phases:
        out["kernel_check"] = kernel_phase(args.seed)
    if "train_kernel_check" in phases:
        out["train_kernel_check"] = train_kernel_phase(args.seed)
    parent = parent_ln(args.parent_ln) if args.parent_ln else None
    if "ln_kernel_check" in phases:
        out["ln"] = ln_kernel_phase(args.seed, parent)
    if "head_dim_check" in phases:
        head_dim_phase(args.seed, args.parent_wide)
    if "dsp_kernel_check" in phases:
        out["dsp"] = dsp_kernel_phase(args.seed)
    if "adam_kernel_check" in phases:
        out["adam"] = adam_kernel_phase(args.seed)
    if {"decode_kernel_check", "main_path", "main_path_fused", "vocode",
            "cli", "eval_service"} & set(phases):
        hp = default_config()
        model = flagship_model(hp, args.seed, "cuda")
        batch = flagship_batch(hp, args.seed)
        if "decode_kernel_check" in phases:
            out["decode"] = decode_kernel_phase(model, hp, batch, args.seed,
                                                args.parent_decoder)
        synthesis = None
        if "main_path" in phases:
            out["eager"], synthesis = main_path_phase(model, hp, batch,
                                                      args.seed)
        if "main_path_fused" in phases:
            out["fused"] = main_path_fused_phase(model, hp, batch)
        if "vocode" in phases:
            synthesis = synthesis or synthesize_batch(
                model, batch, hp, deterministic=True,
                collect_alignments=False, max_frames=512)
            vocode_phase(synthesis["mel_aft"],
                         synthesis["generated_lengths"], hp)
        if "cli" in phases:
            cli_phase(model, args.out_dir)
        if "eval_service" in phases:
            out["eval"] = eval_service_phase(model, hp, batch, args.out_dir,
                                             args.seed, smi)
        del model
    train_sec = state = None
    if "train" in phases:
        out["train"], train_sec, state = train_phase(
            args.seed, parent_ln_fn=parent[0] if parent else None)
    if "train_fused_adam" in phases:
        out["train_fused_adam"] = train_fused_adam_phase(args.seed, state,
                                                         train_sec)
    if "train_cli" in phases:
        train_cli_phase(args.out_dir, args.seed)
    if "corpus" in phases:
        out["corpus"] = corpus_phase(args.out_dir, args.seed, smi)
    if "converge" in phases:
        out["converge"] = converge_phase(args.out_dir, args.seed, smi)
    if "ddp" in phases:
        out["ddp"] = ddp_phase(args.out_dir, args.seed, smi)
    if "remat" in phases:
        out["remat"] = remat_phase(args.seed, smi)
    if "runtime" in phases:
        out["runtime"] = runtime_phase(args.out_dir, args.seed, smi)
    if "tp" in phases:
        out["tp"] = tp_phase(args.out_dir, args.seed, smi)
    emit({"phase": "script", "seconds": time.perf_counter() - script_tic})
    if tuple(phases) != PHASES:
        emit({"partial": list(phases)})
        return

    rows = out["train_kernel_check"]
    train = out["train"]
    paths = lambda name: {
        "synthesize_batch": out["eager"][name],
        "synthesize_batch_fused": out["fused"][name],
        "eval_service": out["eval"][name],
        "train_10_steps": train[name],
        "train_10_steps_fused_adam": out["train_fused_adam"][name],
        "melspectrogram_batch": out["dsp"]["counts"][name],
        "corpus_mels": out["corpus"]["counts"][name],
        "converge_report": out["converge"]["counts"][name],
        "ddp": out["ddp"]["counts"][name],
        "remat": out["remat"]["counts"][name],
        "runtime": out["runtime"]["counts"][name],
        "tp": out["tp"]["counts"][name]}
    dec = rows["decoder_causal"]
    emit({"kernels": [
        kernel_line("mha_forward", dec["forward"],
                    dec["forward"]["max_abs_err_o"], train["mha_forward"],
                    paths("mha_forward")),
        kernel_line("mha_backward", dec["backward_0.1"],
                    max(dec["backward_0.1"]["max_abs_err_" + g]
                        for g in ("dq", "dk", "dv")),
                    train["mha_backward"], paths("mha_backward")),
        kernel_line("layer_norm_backward", out["ln"]["ln_decoder"],
                    out["ln"]["ln_decoder"]["max_abs_err_dx"],
                    train["layer_norm_backward"],
                    paths("layer_norm_backward")),
        # the fused decode's main path is synthesis; a frame at step 256
        kernel_line("decoder_frame_step", out["decode"][256],
                    out["decode"][256]["max_abs_err"],
                    out["fused"]["decoder_frame_step"],
                    paths("decoder_frame_step"),
                    barriers_per_frame=out["decode"]["barriers_per_frame"]),
        # the corpus packer's mels stage on the card: one launch a batch;
        # the times of its largest LJSpeech batch
        kernel_line("fused_frame_mel", out["corpus"]["batch"],
                    out["corpus"]["batch"]["max_abs_err"],
                    out["corpus"]["counts"]["fused_frame_mel"],
                    paths("fused_frame_mel")),
        # use_fused_adam training: one launch over 37 leaves per step
        kernel_line("fused_adam_step", out["adam"],
                    out["adam"]["max_abs_err"],
                    out["train_fused_adam"]["fused_adam_step"],
                    paths("fused_adam_step")),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
