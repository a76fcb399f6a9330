"""Autoregressive synthesis with per-layer KV caches; counterpart of
``few_shot_transformer_tts_tpu/infer/synthesize.py``.

Semantics as in the JAX package (reference synthesize.py:17-72): finished
rows feed zero prenet inputs, ``finished`` latches on ``stop_logit > 0``,
lengths freeze at the stop frame, generation stops at the frame cap or when
every row has finished, the postnet runs once at the end, and RTF is logged
as ``wall_time * 80 / frames``.

Two dropout modes: ``deterministic=True`` (dropout off), and the reference's
decoder-dropout-on sampling (``m.eval(); m.decoder.train()``, reference
eval.py:116-117) with the masks drawn from a ``torch.Generator``.

The frame loop is a Python loop.  Each frame runs either the eager decoder
step (per-layer PyTorch ops over KV caches) or, with
``hp.use_pallas_decode`` on a deterministic decode without self-alignments
(the JAX package's dispatch, less its TPU-only width gate), the fused step:
one ``ops/decode.py:decoder_frame_step`` call runs every decoder layer.  On
a card the fused step's ~45 small ops between two kernel launches (cache
writes, output LN and heads, the stop bookkeeping, the next frame's prenet
and PE) are captured once per call as a CUDA graph after frame 0 and
replayed every later frame, so the host enqueues a frame in one kernel
launch and one graph launch.  The loop asks the device whether every row
has finished only every ``_STOP_CHECK_INTERVAL`` frames, so the host does
not wait on the device each frame; frames run after the last row finished
change no returned value (rows are independent, lengths are frozen, and the
outputs are cut at the true step count).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..config import Config
from ..models.common import (NEG_INF, length_mask, padding_bias,
                             sinusoid_position_encoding)
from ..models.tacotron import ByteToMel
from ..ops import decode
from ..utils import tracing
from . import flow

_STOP_CHECK_INTERVAL = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def prepare_decode_inputs(batch: Dict[str, Any], hp: Config):
    """Pad a synthesis batch onto the shape lattice (T_in and B rounded up).
    Returns numpy (inputs [Bp, Tp] int32, input_lengths [Bp], spk_ids [Bp],
    language_vecs [Bp, L])."""
    inputs = np.asarray(batch["inputs"])
    b, t_in = inputs.shape
    t_pad = _round_up(max(t_in, 1), hp.input_length_multiple)
    b_pad = _round_up(b, hp.batch_size_multiple)
    inputs_p = np.zeros((b_pad, t_pad), np.int32)
    inputs_p[:b, :t_in] = inputs
    input_lengths = np.zeros((b_pad,), np.int32)
    input_lengths[:b] = np.asarray(batch["input_lengths"])
    # padded rows get length 1 to keep softmax well-defined; they stop on cap
    input_lengths[b:] = 1
    spk = np.zeros((b_pad,), np.int32)
    if batch.get("input_spk_ids") is not None:
        spk[:b] = np.asarray(batch["input_spk_ids"], np.int32)
    lvec = np.zeros((b_pad, hp.max_num_language), np.float32)
    if batch.get("input_language_vecs") is not None:
        lvec[:b] = np.asarray(batch["input_language_vecs"], np.float32)
    return inputs_p, input_lengths, spk, lvec


@contextlib.contextmanager
def matmul_weights_in(model: ByteToMel, dtype: torch.dtype):
    """Within the block, Linear/Conv weights and embedding tables are held in
    ``dtype``: cast once ahead of the frame loop instead of at every use (as
    the JAX package pre-casts kernels and embeddings to bf16).  Norm
    parameters, biases and ``pe_scale`` stay fp32.  The fp32 parameters are
    restored on exit."""
    saved = []
    with tracing.span("synth.weights"):
        for mod in model.modules():
            w = getattr(mod, "weight", None)
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Embedding)) and \
                    w.dtype != dtype:
                saved.append((mod, w))
                mod.weight = nn.Parameter(w.detach().to(dtype),
                                          requires_grad=False)
    try:
        yield model
    finally:
        for mod, w in saved:
            mod.weight = w


def _eager_frames(model: ByteToMel, enc_args, memory_bias, max_frames: int,
                  deterministic: bool, collect_self: bool,
                  generator: Optional[torch.Generator]):
    """The per-layer decoder step over KV caches: a function (prev_mel,
    step, finished) -> (mel, stop, encdec align [L, B, H, T_in], self align
    [L, B, H, step + 1] or None)."""
    _, memory_kv = model.encode(*enc_args)
    cache = model.init_decode_cache(memory_bias.shape[0], max_frames)

    def frame(prev_mel, step, finished):
        return model.decode_step(
            prev_mel, step, cache, memory_kv, memory_bias,
            decoder_dropout=not deterministic, generator=generator,
            finished=finished, collect_self=collect_self)
    return frame


class _FusedFrames:
    """The fused decoder step (counterpart of the JAX package's
    ``_fused_frames_loop``) over buffers that live for the whole call:
    weights stacked once, memory K/V for every layer in one product, then
    per frame one ``decoder_frame_step`` launch (``launch``) and the chain
    of small ops up to the next frame's launch (``chain``).  The chain
    indexes by ``step_t``, a one-element device tensor, and reads and
    writes these buffers only, so that one CUDA graph of it serves every
    frame.  Deterministic decode only."""

    def __init__(self, model: ByteToMel, enc_args, memory_bias,
                 max_frames: int, collect_alignments: bool):
        hp, dtype = model.hp, model.dtype
        self.model, self.dtype, self.heads = model, dtype, hp.n_attention_head
        self.dec = dec = model.decoder.decoder
        enc = model.encoder(*enc_args, deterministic=True)
        self.device = dev = enc.device
        with tracing.span("synth.weights"):
            self.w = decode.stack_decoder_params(dec, dtype)
            self.mem_k, self.mem_v = decode.project_memory(
                enc, self.w.pop("w_kv"), dtype)
        b, self.t_in = memory_bias.shape[0], memory_bias.shape[-1]
        self.bias = F.pad(memory_bias[:, 0, 0, :].float(),
                          (0, self.mem_k.shape[2] - self.t_in),
                          value=NEG_INF)
        cache_shape = (hp.n_decoder_layer, b, decode.padded_cap(max_frames),
                       hp.decoder_hidden)
        self.cache_k = torch.zeros(cache_shape, dtype=dtype, device=dev)
        self.cache_v = torch.zeros(cache_shape, dtype=dtype, device=dev)
        # a row past the cap: the chain after the last frame makes an input
        # that no frame reads
        self.pe = sinusoid_position_encoding(max_frames + 1,
                                             hp.decoder_hidden, dev)
        self.step_t = torch.zeros(1, dtype=torch.int64, device=dev)
        self.x = torch.empty(b, hp.decoder_hidden, device=dev)
        self.mels = torch.zeros(b, max_frames, hp.num_mels, device=dev)
        self.finished = torch.zeros(b, dtype=torch.bool, device=dev)
        self.target_lengths = torch.ones(b, dtype=torch.int32, device=dev)
        self.prev_mel = torch.zeros(b, hp.num_mels, device=dev)
        # [L, B, H, T_dec, T_enc]
        self.aligns = torch.zeros(
            hp.n_decoder_layer, b, self.heads, max_frames, self.t_in,
            device=dev) if collect_alignments else None
        self.out = decode.FrameStepOut(
            self.x, self.w, self.cache_k, self.cache_v, self.mem_k,
            self.mem_v, self.bias, num_heads=self.heads)
        self.inputs()

    def launch(self, step: int):
        """The kernel of frame ``step`` (= ``step_t``), on the host: its
        outputs, ``out``'s buffers."""
        return decode.decoder_frame_step(
            self.x, step, self.w, self.cache_k, self.cache_v, self.mem_k,
            self.mem_v, self.bias, num_heads=self.heads, out=self.out)

    def inputs(self):
        """Frame ``step_t``'s kernel input ``x``: the prenet of the previous
        frame, zeros for finished rows, plus the PE at ``step_t``."""
        x = self.model.decoder_inputs(self.prev_mel, self.finished)
        pe = self.pe.index_select(0, self.step_t)
        self.x.copy_(x + pe.to(x.dtype) * self.dec.pe_scale.to(x.dtype))

    def chain(self, outputs):
        """After frame ``step_t``'s kernel, on its ``outputs``: its k/v into
        the caches, the output LN and the mel and stop heads, its mel (and
        cross-attention weights) into the call's buffers, ``finished``,
        ``target_lengths`` and ``prev_mel``; then ``step_t`` + 1 and that
        frame's input."""
        x_out, align, k_new, v_new = outputs
        t = self.step_t
        self.cache_k.index_copy_(2, t, k_new[:, :, None])
        self.cache_v.index_copy_(2, t, v_new[:, :, None])
        mel, stop = self.model.decoder_outputs(
            self.dec.output_layer_norm(x_out.to(self.dtype)))
        self.mels.index_copy_(1, t, mel[:, None])
        if self.aligns is not None:
            # [L, B, TmP, H] -> [L, B, H, 1, T_in]
            self.aligns.index_copy_(
                3, t, align.permute(0, 1, 3, 2)[:, :, :, None, :self.t_in])
        self.finished |= stop > 0
        self.target_lengths += ~self.finished
        self.prev_mel.copy_(mel)
        t += 1
        self.inputs()


def _steps(max_frames: int, finished: torch.Tensor):
    """Frame steps 0, 1, .. up to the cap, or until every row has finished:
    the device is asked only every ``_STOP_CHECK_INTERVAL`` frames."""
    for step in range(max_frames):
        if step % _STOP_CHECK_INTERVAL == 0 and step:
            with tracing.span("synth.stop_check"):
                done = bool(finished.all())
            if done:
                return
        yield step


# one side stream per device and thread (``_side_stream``)
_SIDE_STREAMS = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's stream for frame 0's chain and its capture on
    ``device``: one for every call, so that cuBLAS keeps one workspace for
    it (a fresh stream a call would get a workspace each)."""
    key = (device, threading.get_ident())
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[key]


@contextlib.contextmanager
def _on(stream: Optional[torch.cuda.Stream]):
    """Work inside the block runs on ``stream`` after the current stream's
    earlier work, and the current stream's later work after it (nothing
    changes when ``stream`` is None)."""
    if stream is None:
        yield
        return
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        yield
    main.wait_stream(stream)


def _capture(fn, stream: torch.cuda.Stream) -> torch.cuda.CUDAGraph:
    """``fn``'s device work as a CUDA graph, captured on ``stream`` (where
    ``fn`` ran once eagerly)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    return graph


def _fused_loop(fr: _FusedFrames, max_frames: int) -> int:
    """The fused frame loop; returns the frames run.  Frame 0's chain runs
    eagerly; on a card it runs on a side stream, where it is then captured
    as a CUDA graph that later frames replay after their kernel, as long as
    the kernel entry returns the buffers the graph reads (otherwise their
    chain runs eagerly too)."""
    side = _side_stream(fr.device) if fr.device.type == "cuda" else None
    graph = captured = None
    eager = steps_run = 0
    for step in _steps(max_frames, fr.finished):
        with tracing.span("synth.frame"):
            outputs = fr.launch(step)
            if graph is not None and all(
                    a is b for a, b in zip(outputs, captured)):
                graph.replay()
            else:
                with _on(side):
                    fr.chain(outputs)
                eager += 1
        steps_run = step + 1
        if graph is None and side is not None and steps_run < max_frames:
            with tracing.span("synth.capture"):
                graph = _capture(lambda: fr.chain(outputs), side)
            captured = outputs
    tracing.count("synth.eager_frames", eager)
    tracing.count("synth.graph_frames", steps_run - eager)
    return steps_run


@torch.no_grad()
def _decode_loop(model: ByteToMel, inputs, input_lengths, input_spk_ids,
                 input_language_vecs, max_frames: int, deterministic: bool,
                 collect_alignments: bool, collect_self: bool,
                 use_fused: bool, generator: Optional[torch.Generator]):
    hp = model.hp
    b, t_in = inputs.shape
    enc_args = (inputs, input_lengths, input_spk_ids, input_language_vecs)
    dev = inputs.device
    with tracing.span("synth.encode"):
        memory_bias = padding_bias(length_mask(input_lengths, t_in))
        if use_fused:
            fr = _FusedFrames(model, enc_args, memory_bias, max_frames,
                              collect_alignments)
            mels, finished = fr.mels, fr.finished
            target_lengths = fr.target_lengths
        else:
            frame = _eager_frames(model, enc_args, memory_bias, max_frames,
                                  deterministic, collect_self, generator)
            mels = torch.zeros(b, max_frames, hp.num_mels, device=dev)
            # self-attention rows over the decoded frames; opt-in,
            # O(L*B*H*T^2)
            self_aligns = torch.zeros(
                hp.n_decoder_layer, b, hp.n_attention_head, max_frames,
                max_frames, device=dev) if collect_self else None
            finished = torch.zeros(b, dtype=torch.bool, device=dev)
            target_lengths = torch.ones(b, dtype=torch.int32, device=dev)
            prev_mel = torch.zeros(b, hp.num_mels, device=dev)
    aligns = []
    steps_run = 0
    with tracing.span("synth.frames"):
        if use_fused:
            steps_run = _fused_loop(fr, max_frames)
        else:
            for step in _steps(max_frames, finished):
                with tracing.span("synth.frame"):
                    mel, stop, align, self_align = frame(prev_mel, step,
                                                         finished)
                    mels[:, step] = mel
                    if collect_alignments:
                        aligns.append(align)
                    if collect_self:
                        self_aligns[:, :, :, step, :step + 1] = self_align
                    finished |= stop > 0
                    target_lengths += ~finished
                    prev_mel = mel
                steps_run = step + 1
        tracing.count("synth.frame_steps", steps_run)
        # the JAX loop stops after the step at which the last row finished
        n_steps = min(int(target_lengths.max()), steps_run)
    with tracing.span("synth.postnet"):
        residual = model.postnet_residual(mels, target_lengths)
    if not collect_alignments:
        align_t = None
    elif use_fused:
        align_t = fr.aligns[:, :, :, :n_steps]
    else:
        align_t = torch.stack(aligns[:n_steps], dim=3)
    # [L, B, H, T_dec, T_enc]
    return (mels, mels + residual, target_lengths, align_t,
            self_aligns[..., :n_steps, :n_steps] if collect_self else None,
            n_steps)


def synthesize_batch(model: ByteToMel, batch: Dict[str, Any], hp: Config,
                     deterministic: bool = False,
                     generator: Optional[torch.Generator] = None,
                     collect_alignments: bool = True,
                     collect_self_alignments: bool = False,
                     max_frames: Optional[int] = None) -> Dict[str, Any]:
    """Greedy AR synthesis of a packed batch (reference synthesize.py:17-72)
    on the model's device.

    batch needs inputs [B, Tin] and input_lengths [B]; optional
    input_spk_ids, input_language_vecs, names.  Returns the reference's
    result dict (numpy): names, mel_pre, mel_aft, alignments (``encdec``: a
    list per decoder layer of [B, H, T_enc, T_dec]; ``self``: the same with
    the decoded frames as memory, [B, H, T_dec, T_dec], when
    ``collect_self_alignments``, an opt-in O(L*B*H*T^2) buffer),
    input_lengths, generated_lengths.  With ``deterministic=False`` decoder
    dropout is on and its masks come from ``generator`` (a fresh randomly
    seeded one if None).  ``hp.use_pallas_decode`` selects the fused decoder
    step for deterministic decodes without self-alignments.

    With ``hp.model == "f5tts"`` the batch is F5-TTS's (prompt mels, prompt
    and target text) and the flow sampler of ``infer/flow.py`` runs it
    (``generator`` draws its noise; ``deterministic`` and the alignment
    flags do not apply); the result holds ``mel_aft`` = ``mel_pre`` and
    ``generated_lengths``, each row's total frames.
    """
    with tracing.span("synth.call"):
        if hp.model == "f5tts":
            return flow.sample(model, batch, hp, generator, max_frames)
        return _synthesize(model, batch, hp, deterministic, generator,
                           collect_alignments, collect_self_alignments,
                           max_frames)


def _synthesize(model, batch, hp, deterministic, generator,
                collect_alignments, collect_self_alignments, max_frames):
    tic = time.time()
    dev = model.device
    with tracing.span("synth.prepare"):
        inputs = np.asarray(batch["inputs"])
        b, t_in = inputs.shape
        padded = prepare_decode_inputs(batch, hp)
        if not deterministic and generator is None:
            generator = torch.Generator(dev)
            generator.seed()
        cap = int(max_frames or hp.max_generation_frames)
        use_fused = bool(hp.use_pallas_decode and deterministic and
                         not collect_self_alignments)
        args = [torch.from_numpy(a).to(dev) for a in padded]

    with matmul_weights_in(model, model.dtype):
        mels, mel_aft, target_lengths, aligns, self_aligns, n_steps = \
            _decode_loop(model, *args, cap, deterministic,
                         collect_alignments, collect_self_alignments,
                         use_fused, generator)

    with tracing.span("synth.fetch"):
        mels = mels[:b, :n_steps].cpu().numpy()
        mel_aft = mel_aft[:b, :n_steps].cpu().numpy()
        target_lengths = target_lengths[:b].cpu().numpy()
    toc = time.time()
    total_length = int(target_lengths.sum())
    logging.info(
        "Time: %.4f, Samples: %d, Length: %d, Max length: %d, "
        "Real-time Factor: %.4f",
        toc - tic, b, total_length, int(target_lengths.max()),
        (toc - tic) / max(total_length, 1) * 80)

    alignments = {"self": None, "encdec": None}
    if collect_alignments:
        a = aligns[:, :b, :, :, :t_in].float().cpu().numpy()
        # reference layout: list per layer of [B, H, T_enc(mem), T_dec(query)]
        alignments["encdec"] = [a[i].transpose(0, 1, 3, 2)
                                for i in range(a.shape[0])]
    if collect_self_alignments:
        s = self_aligns[:, :b].float().cpu().numpy()
        # same layout with mem = decoded frames (reference synthesize.py:69-71)
        alignments["self"] = [s[i].transpose(0, 1, 3, 2)
                              for i in range(s.shape[0])]

    return {"names": batch.get("names", [str(i) for i in range(b)]),
            "mel_pre": mels, "mel_aft": mel_aft,
            "alignments": alignments,
            "input_lengths": list(np.asarray(batch["input_lengths"])),
            "generated_lengths": list(target_lengths)}


def vocode_batch(mel_aft, generated_lengths, hp: Config, device="cuda"):
    """Batched Griffin-Lim on ``device`` (``ops/dsp_torch.py:mel2wav``):
    one pass of ``hp.n_iter`` STFT round trips for the whole padded batch,
    instead of the reference's per-sample CPU loop (reference
    synthesize.py:82).  Returns per-sample float32 waveforms (numpy)
    trimmed to (length - 1) * hop samples."""
    from ..ops import dsp_torch
    from ..utils.device import resolve_device
    with tracing.span("vocode.call"):
        with tracing.span("vocode.griffin_lim"):
            mel = torch.as_tensor(np.asarray(mel_aft, np.float32)).to(
                resolve_device(device))
            wavs = dsp_torch.mel2wav(mel, hp)
        with tracing.span("vocode.fetch"):
            wavs = wavs.cpu().numpy()
            return [wavs[i][:max(0, int(n) - 1) * hp.hop_length]
                    for i, n in enumerate(generated_lengths)]


def save_eval_results(names, mel_pre, mel_aft, alignments, input_lengths,
                      generated_lengths, output_dir, hp: Config,
                      save_trimmed_wave: bool = False,
                      n_plot_alignment: Optional[int] = None,
                      wavs=None):
    """Save per-sample mel ``.npy``, Griffin-Lim ``.wav`` (CPU, numpy),
    optionally ``_trim.wav``, and plots (reference synthesize.py:75-106);
    4-thread pool as in the reference.  ``wavs`` (from ``vocode_batch``)
    replaces the per-sample numpy Griffin-Lim; alignments are plotted for
    the first ``n_plot_alignment`` samples (all when None).  Takes numpy
    only, so a process pool can run it."""
    from ..ops import dsp
    from ..utils import infolog

    def save_i(i):
        try:
            name = names[i]
            mel = mel_aft[i][:generated_lengths[i]]
            np.save(os.path.join(output_dir, "%s.npy" % name), mel)
            wav = wavs[i] if wavs is not None else dsp.mel2wav(mel, hp)
            if len(wav) == 0:
                wav = np.zeros(hp.hop_length, np.float32)
            dsp.save_wav(wav, os.path.join(output_dir, "%s.wav" % name), hp.sr)
            if save_trimmed_wave:
                dsp.save_wav(dsp.trim_silence_intervals(wav, hp),
                             os.path.join(output_dir, "%s_trim.wav" % name),
                             hp.sr)
            infolog.plot_mel(os.path.join(output_dir, "%s_mel.png" % name), mel)
            if (n_plot_alignment is None or i < n_plot_alignment) and \
                    alignments.get("encdec") is not None:
                aligns = [a[i].transpose([0, 2, 1])
                          for a in alignments["encdec"]]
                infolog.plot_attn(
                    aligns, os.path.join(output_dir, "%s_align.png" % name),
                    enc_length=input_lengths[i],
                    dec_length=generated_lengths[i])
        except Exception:
            logging.error("Fail to produce eval output: %s", names[i])
            logging.error(traceback.format_exc())

    tic = time.time()
    with ThreadPoolExecutor(max_workers=4) as ex:
        futures = [ex.submit(save_i, i) for i in range(len(names))]
        [f.result() for f in futures]
    logging.info("[%s] Finished saving evals in %.2f secs: %s",
                 threading.current_thread().name, time.time() - tic,
                 str(names))
