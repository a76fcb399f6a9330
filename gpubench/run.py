"""The benchmark of the PyTorch/CUDA port ``few_shot_transformer_tts_torch``.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It makes the cell's inputs and weights from the seed, warms up the cell's
shapes (set-up), runs the cell's traffic against the program for
``--seconds``, checks what the timed path produced against the plain
reference in ``gpubench/reference/``, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``; its per-layer metrics, read
from a profiled stretch of the window, with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also printed as the last lines of standard
error.

It exits non-zero without a result when there is no card, when the cell is
unknown, when the program is not in the checkout, and when the process has
loaded JAX, flax or the JAX package.  Kernel and compiler caches live in
fixed directories under the checkout's ``build/``; the inputs it writes
(the training corpus) and the profiler's trace live in a directory under
``TMPDIR`` that it removes at exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "few_shot_transformer_tts_tpu")


def cache_env(root: Path):
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds (the port's own kernel libraries already
    live in ``build/torch_kernels`` and ``build/native``)."""
    base = root / "build" / "gpubench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name starts with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def run_cell(cell, seed, seconds, trace, device, t_start, variants=()):
    """Set-up, window and check of one cell: (result dict, stderr lines,
    the variants' numbers)."""
    import torch

    from .drivers import driver
    from .drivers.common import Context
    from .trace import Tracer
    workdir = tempfile.mkdtemp(prefix="gpubench-")
    try:
        ctx = Context(cell, seed, device, workdir, t_start)
        drv = driver(cell.mix["kind"])(ctx)
        drv.setup()
        cuda = device.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        tracer = Tracer(trace, workdir, device)
        tracer.warm()
        tracer.install()
        try:
            outcome = drv.window(seconds, tracer)
        finally:
            tracer.uninstall()
        t_check = time.perf_counter()
        numbers, notes, extra = drv.check(variants)
        notes["check_s"] = time.perf_counter() - t_check
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    peak = max(setup_peak, outcome.readings.peak_bytes)
    return assemble(cell, outcome, numbers, notes, trace, device, peak) + \
        (extra,)


def assemble(cell, outcome, numbers, notes, trace, device, peak):
    import torch
    limits = cell.limits.get("limits", {})
    checks = {n: {"value": v, "limit": limits.get(n)}
              for n, v in numbers.items()}
    correct = outcome.failed == 0 and bool(checks) and all(
        c["limit"] is not None and _finite(c["value"]) and
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.readers[m["name"]](outcome.readings)
            if v is not None and _finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": dev}
    t = outcome.trace
    if trace and t is not None:
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.device_ops,
                               "idle_gaps": t.idle_gaps}
    result["checks"] = checks
    traced = {} if t is None else {
        "trace": {"extra": t.extra, "entry_device_s": t.entry_device_s,
                  "entry_bound_s": t.entry_bound_s,
                  "entry_calls": t.entry_calls, "kernels": t.kernels}}
    lines = ["%s: %s" % (k, json.dumps(v)) for k, v in
             {**outcome.notes, **notes, **traced}.items()]
    lines += ["%s %r limit %r" % (n, c["value"], c["limit"])
              for n, c in checks.items()]
    return result, lines


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    import torch
    from . import spec
    try:
        cell = spec.load_cell(ROOT, args.workload)
    except (KeyError, OSError) as e:
        print("gpubench: %s" % e, file=sys.stderr)
        return 2
    chips = next(w["chips"] for w in spec.load_json(
        ROOT / "BENCHMARK.json")["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("gpubench: the cell needs %d CUDA device(s); this machine has "
              "%s" % (chips, torch.cuda.device_count()
                      if torch.cuda.is_available() else "none"),
              file=sys.stderr)
        return 3
    try:
        import few_shot_transformer_tts_torch  # noqa: F401
    except ImportError as e:
        print("gpubench: the program few_shot_transformer_tts_torch is not "
              "in this checkout (%s)" % e, file=sys.stderr)
        return 4
    result, lines, _ = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                T_START)
    bad = loaded_forbidden()
    if bad:
        print("gpubench: the process loaded %s; the benchmark runs the port "
              "without JAX" % ", ".join(bad), file=sys.stderr)
        return 5
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
