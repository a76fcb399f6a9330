"""One-edit mutants of the LayerNorm backward kernel
(few_shot_transformer_tts_torch/csrc/layernorm_bwd.cu): each is run through
``chip_smoke.py --phases ln_kernel_check`` in a copy of the port under
build/ln_mutants/<name>/, and each must fail it.  Needs the card and nvcc.

    python3 tools/ln_bwd_mutants.py

The copies share the build cache (build/torch_kernels), so only the mutated
library is rebuilt.  Prints one JSON line per mutant (exit code, the last
case it reached, that case's errors) and a last line {"all_failed": ...};
exits 1 unless every mutant failed.
"""

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from few_shot_transformer_tts_torch.ops import cuda_build  # noqa: E402

SOURCE = "few_shot_transformer_tts_torch/csrc/layernorm_bwd.cu"
MUTANTS = {
    # the last row of a block's range left out of dgamma
    "last_row_out_of_dgamma": (
        "    row_backward(row, gam, acc_g, acc_b,\n"
        "                 dx + (first + static_cast<long long>(i) * kWarps)"
        " * cols,\n"
        "                 lane, cols, p.eps);\n",
        "    float keep[kN];\n"
        "    for (int k = 0; k < kN; ++k) keep[k] = acc_g[k];\n"
        "    row_backward(row, gam, acc_g, acc_b,\n"
        "                 dx + (first + static_cast<long long>(i) * kWarps)"
        " * cols,\n"
        "                 lane, cols, p.eps);\n"
        "    if (first + static_cast<long long>(i) * kWarps == end - 1)\n"
        "      for (int k = 0; k < kN; ++k) acc_g[k] = keep[k];\n"),
    # the scalar variant's last column of dy read as 0
    "scalar_tail_column_skipped": (
        "      dy[s] = c < cols ? dyr[c] : from_float<T>(0.f);",
        "      dy[s] = c < cols - 1 ? dyr[c] : from_float<T>(0.f);"),
    # the column pass reads the next partial row (the first never, the last
    # twice)
    "column_sum_neighbour_row": (
        "          const int part = first + k * groups;\n"
        "          v[k] = part < parts ? __ldcg(p.partial +\n"
        "                                       static_cast<long long>(part)"
        " * total + q)\n",
        "          const int part = first + k * groups;\n"
        "          v[k] = part < parts ? __ldcg(p.partial +\n"
        "                                       static_cast<long long>("
        "min(part + 1, parts - 1)) * total + q)\n"),
    # s1 = mean(g * xhat) left out of dx
    "s1_out_of_dx": (
        "    d[i] = rstd * (g[i] - xh[i] * s1 - s0);",
        "    d[i] = rstd * (g[i] - s0);"),
    # the block's sums leave out its last warp
    "block_sum_drops_a_warp": (
        "    for (int w = 0; w < kWarps; ++w) t += red[w * total + q];",
        "    for (int w = 0; w < kWarps - 1; ++w) t += red[w * total + q];"),
}


def main():
    tic = time.time()
    cuda_build.build_all()
    print(json.dumps({"shared_build_s": time.time() - tic}), flush=True)
    results = {}
    for name, (old, new) in MUTANTS.items():
        d = os.path.join(ROOT, "build", "ln_mutants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "few_shot_transformer_tts_torch"),
                        os.path.join(d, "few_shot_transformer_tts_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
        os.makedirs(os.path.join(d, "build"))
        os.symlink(str(cuda_build.BUILD_DIR),
                   os.path.join(d, "build", "torch_kernels"))
        path = os.path.join(d, SOURCE)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise RuntimeError("mutant %s: its edit does not match the "
                               "source once" % name)
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        tic = time.time()
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py", "--phases", "ln_kernel_check"],
            cwd=d, capture_output=True, text=True, timeout=900)
        rows = [json.loads(line) for line in proc.stdout.splitlines()
                if line.startswith("{") and '"case"' in line]
        last = rows[-1] if rows else {}
        errors = [line for line in proc.stderr.splitlines()
                  if "Error" in line][-1:]
        results[name] = {
            "exit": proc.returncode, "failed": proc.returncode != 0,
            "seconds": time.time() - tic, "last_case": last.get("case"),
            "last_errors": {k: v for k, v in last.items()
                            if k.startswith(("rel_err", "repeat"))},
            "error": [e[:300] for e in errors]}
        print(json.dumps({name: results[name]}), flush=True)
    ok = all(r["failed"] for r in results.values())
    print(json.dumps({"all_failed": ok}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
