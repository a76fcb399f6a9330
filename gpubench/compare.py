"""The numbers the correctness check compares, each against a limit.

Training (the first steps of the run, which the window continues, and one
step of the window replayed from the program's state before it):
  loss_gap      the largest relative gap between the program's and the
                reference's loss over the compared steps
  grad_gap      the worst leaf's gap between the norms of the program's
                and the reference's first gradient, over the larger of the
                reference leaf's norm and the median leaf's
  update_gap    the same for the parameters' change over the compared
                steps, leaving out the leaves whose reference gradient is
                under a thousandth of the median leaf's (they move by
                round-off alone under Adam)
  window_grad_gap, window_update_gap
                the same two of the checked window step, the reference
                starting from the program's parameters and Adam moments
                copied before it
  batch_faults  how many fields or packing rules of the program's packed
                batches depart from the ones worked out again (limit 0)
Synthesis (a sample of what the window produced):
  frame_gap     the widest gap between a frame the program decoded and the
                reference's prediction at that position from the program's
                previous frames, over the RMS of the reference's frames of
                that row; the worst sampled row
  postnet_gap   the same for the postnet's residual on the program's mels
  length_faults rows whose length differs from the reference's stop
                decisions (limit 0)
  wave_len_faults  waveforms whose length is not (frames - 1) x hop
                (limit 0)
  wave_sc_gap   the worst sampled waveform's spectral convergence against
                the magnitude its mel asks for, less what a float64
                Griffin-Lim of the same mel reaches (``reference/vocoder.py``)
"""

from __future__ import annotations

import numpy as np


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def norm_gap(program: dict, reference: dict, leaves=None):
    """(worst leaf's gap, that leaf) of two {leaf: norm} maps."""
    leaves = list(reference) if leaves is None else list(leaves)
    med = float(np.median([reference[n] for n in leaves]))
    worst, leaf = 0.0, None
    for n in leaves:
        g = abs(program[n] - reference[n]) / max(reference[n], med, 1e-30)
        if g > worst or leaf is None:
            worst, leaf = g, n
    return worst, leaf


def moving_leaves(grad_norms: dict) -> list:
    med = float(np.median(list(grad_norms.values())))
    return [n for n, g in grad_norms.items() if g >= 1e-3 * med]


def widest_gap(program, reference) -> float:
    """max |program - reference| over the RMS of reference."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    rms = float(np.sqrt(np.mean(r * r)))
    return float(np.max(np.abs(p - r))) / max(rms, 1e-30)


def rel_l2(program, reference) -> float:
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    return float(np.linalg.norm(p - r)) / max(float(np.linalg.norm(r)),
                                              1e-30)
