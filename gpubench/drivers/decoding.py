"""The check shared by the synthesis drivers: the reference judges sampled
rows of what the program decoded.

For a sampled row, the reference runs its encoder on the row's unpadded
text, then its decoder over the program's own frames as the previous
outputs (teacher forcing on what was served, so one early gap does not
carry into every later frame), and its postnet on the program's mel.  The
frames compared are those up to the row's stop (later ones fed the
decoder zeros).  The row's length is held to the reference's stop
decisions: the first position whose stop logit is positive, plus one, or,
for a row that never stops within the frames run, one more than them (the
reference implementation's count).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import compare
from ..reference import model as ref_model


def row_inputs(batch, r, dev):
    n = int(batch["input_lengths"][r])
    ids = torch.from_numpy(np.asarray(batch["inputs"][r, :n])[None]).to(dev)
    lengths = torch.tensor([n], device=dev)
    spk = lvec = None
    if "input_spk_ids" in batch:
        spk = torch.from_numpy(batch["input_spk_ids"][r:r + 1]).to(dev)
    if "input_language_vecs" in batch:
        lvec = torch.from_numpy(batch["input_language_vecs"][r:r + 1]).to(dev)
    return ids, lengths, spk, lvec


@torch.no_grad()
def judge_row(P, hp, batch, r, mel_pre, mel_aft, length, cap, dev,
              Q=ref_model.exact):
    """{number: value} of one row: ``mel_pre``/``mel_aft`` [T, M] and
    ``length`` are what the program returned for it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = mel_pre.shape[0]
    memory = ref_model.encoder(P, hp, *row_inputs(batch, r, dev), Q=Q)
    frames = torch.from_numpy(np.asarray(mel_pre, np.float32))[None].to(dev)
    mel, stop = ref_model.decoder_on_frames(P, hp, memory, frames, Q)
    stops = torch.nonzero(stop[0] > 0)
    want = int(stops[0]) + 1 if len(stops) else (t + 1 if t == cap else -1)
    n = min(int(length), t)
    lengths = torch.tensor([n], device=dev)
    res = ref_model.postnet(P, hp, frames[:, :n], lengths, Q=Q)[0]
    res_prog = np.asarray(mel_aft[:n], np.float64) - \
        np.asarray(mel_pre[:n], np.float64)
    return {"frame_gap": compare.widest_gap(mel_pre[:n], mel[0, :n].cpu()),
            "frame_l2": compare.rel_l2(mel_pre[:n], mel[0, :n].cpu()),
            "postnet_gap": compare.widest_gap(res_prog, res.cpu()),
            "postnet_l2": compare.rel_l2(res_prog, res.cpu()),
            "length_faults": int(want != int(length))}


@torch.no_grad()
def predict(P, hp, batch, r, mel_pre, dev, Q):
    """(decoder predictions, postnet residual) of the reference under Q on
    the program's frames of row r, numpy."""
    memory = ref_model.encoder(P, hp, *row_inputs(batch, r, dev), Q=Q)
    frames = torch.from_numpy(np.asarray(mel_pre, np.float32))[None].to(dev)
    mel, _ = ref_model.decoder_on_frames(P, hp, memory, frames, Q)
    lengths = torch.tensor([frames.shape[1]], device=dev)
    res = ref_model.postnet(P, hp, frames, lengths, Q=Q)
    return mel[0].cpu().numpy(), res[0].cpu().numpy()


def control_row(P, hp, batch, r, mel_pre, dev):
    """What the control reads on row r: the gaps between the reference
    with float8 products and the reference, on the program's frames."""
    exact = predict(P, hp, batch, r, mel_pre, dev, ref_model.exact)
    low = predict(P, hp, batch, r, mel_pre, dev, ref_model.fp8)
    return {"frame_gap": compare.widest_gap(low[0], exact[0]),
            "frame_l2": compare.rel_l2(low[0], exact[0]),
            "postnet_gap": compare.widest_gap(low[1], exact[1]),
            "postnet_l2": compare.rel_l2(low[1], exact[1])}


def worst(rows):
    """The worst value of each number over rows (sums for counts)."""
    out = {}
    for row in rows:
        for k, v in row.items():
            if k.endswith("_faults"):
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out[k], v) if k in out else v
    return out
