"""Readings that the correctness limits are set from; not part of a run.

    python3 -m gpubench.calibrate --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--seconds 3]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load (training runs on until its checked window step is done),
and the check, printing the numbers the program reads (the lower
readings).  On the control seeds it also prints what the control reads:
the reference itself, one precision step below the configuration's (bf16
-> float8 e4m3 products; the vocoder's float64 Griffin-Lim -> bf16),
against the reference; for training the planted fault "half of the batch
left out, the mean taken over the rest"; for the vocoder its planted
faults (``reference/vocoder.py``).  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import ROOT, cache_env


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cache_env(ROOT)
    import torch
    from . import spec
    from .run import run_cell
    cell = spec.load_cell(ROOT, args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    variants = {"train": ("fp8", "half"),
                "utterance": ("fp8", "vocoder_faults")}.get(cell.mix["kind"],
                                                           ("fp8",))
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        tic = time.perf_counter()
        result, lines, extra = run_cell(
            cell, seed, args.seconds, False, device, tic,
            variants if seed in controls else ())
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "numbers": {k: c["value"] for k, c in result["checks"].items()},
            "correct": result["correct"], "control": extra,
            "metrics": {k: m["value"] for k, m in result["metrics"].items()},
            "memory_peak_bytes": result["device"]["memory_peak_bytes"],
            "notes": lines, "seconds": time.perf_counter() - tic}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
