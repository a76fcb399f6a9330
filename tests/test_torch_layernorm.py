"""The LayerNorm backward kernel's launch plan (``ln_bwd_plan``) and the order
of its sums, on the CPU (the kernel itself runs only on the card, in
``chip_smoke.py``).

- The variant: 16-byte loads for aligned rows that are whole 16-byte
  vectors, the scalar-load variant for ragged rows and misaligned views; the
  instantiation lists agree with the ones ``csrc/layernorm_bwd.cu`` builds.
- Every row lies in exactly one block's range and one warp's share at rows
  1, 3, 7 and the train shapes 3072, 7168, 7169; no block is empty; the grid
  never exceeds the co-resident blocks; the workspace holds one partial
  [dgamma, dbeta] row per block; the shared memory holds the ring and the
  block's sums and stays within the kernel's limit.
- The kernel's data flow replayed in numpy float32 (each warp's rows in
  order, the block's warps in order, the column pass's groups of partial
  rows in order) against ``layer_norm_backward_plain`` and against
  ``jax.vjp`` of the TPU kernel ``fused_layer_norm`` in interpret mode.
  Tolerance 1e-5 (fp32 summation order only).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.ops.fused_layernorm import \
    fused_layer_norm
from few_shot_transformer_tts_torch.ops import layernorm as L

CU = Path(L.__file__).resolve().parents[1] / "csrc" / "layernorm_bwd.cu"
KERNEL_MAX_SMEM = 8 * 2 * 2 * 1024 * 4      # csrc/layernorm_bwd.cu kMaxSmem


@pytest.mark.parametrize("cols,dtype,aligned,vector,per_lane", [
    (768, torch.bfloat16, True, True, 24),      # decoder
    (512, torch.bfloat16, True, True, 16),      # encoder
    (48, torch.bfloat16, True, True, 8),
    (1024, torch.bfloat16, True, True, 32),
    (768, torch.float32, True, True, 24),
    (1024, torch.float32, True, True, 32),
    (44, torch.float32, True, True, 4),         # 176 bytes: 11 vectors
    (44, torch.bfloat16, True, False, 2),       # 88 bytes: ragged
    (769, torch.float32, True, False, 32),
    (768, torch.bfloat16, False, False, 24),    # a misaligned view
    (1, torch.bfloat16, True, False, 2),
])
def test_variant(cols, dtype, aligned, vector, per_lane):
    assert L.ln_bwd_variant(cols, dtype, aligned) == (vector, per_lane)
    plan = L.ln_bwd_plan(100, cols, dtype, aligned, 132, 1)
    assert (plan.vector, plan.per_lane) == (vector, per_lane)
    assert (plan.depth > 0) == vector


@pytest.mark.parametrize("cols", [0, 1025, 4096])
def test_columns_beyond_the_kernel_raise(cols):
    with pytest.raises(ValueError, match="1 to 1024 columns"):
        L.ln_bwd_plan(10, cols, torch.bfloat16, True, 132, 1)


def test_instantiation_lists_match_the_kernel():
    src = CU.read_text()
    built = set(re.findall(r"X\((__nv_bfloat16|float|T), (\d+), (true|false)\)",
                           src))
    vector = {("bfloat16" if t == "__nv_bfloat16" else "float32", int(k))
              for t, k, v in built if v == "true"}
    assert vector == {(str(d).split(".")[1], k)
                      for d, ks in L.VECTOR_PER_LANE.items() for k in ks}
    assert {int(k) for t, k, v in built if v == "false"} == \
        set(L.SCALAR_PER_LANE)
    assert "constexpr int kWarps = %d;" % L.WARPS_PER_BLOCK in src
    assert "constexpr int kMaxDepth = %d;" % L.MAX_DEPTH in src
    assert "constexpr int kMaxCols = %d;" % L.MAX_COLS in src


def _ranges(plan, rows):
    return [(b * plan.rows_per_block,
             min(rows, (b + 1) * plan.rows_per_block))
            for b in range(plan.grid)]


@pytest.mark.parametrize("rows", [1, 3, 7, 8, 9, 1000, 3072, 7168, 7169])
@pytest.mark.parametrize("sms,blocks_per_sm", [(132, 1), (132, 2), (16, 3),
                                               (1, 1)])
def test_every_row_in_exactly_one_block(rows, sms, blocks_per_sm):
    plan = L.ln_bwd_plan(rows, 768, torch.bfloat16, True, sms, blocks_per_sm)
    ranges = _ranges(plan, rows)
    assert all(lo < hi for lo, hi in ranges)            # no empty block
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    np.testing.assert_array_equal(covered, np.arange(rows))
    # the block's warps: warp w takes rows lo + w, lo + w + 8, ...
    warp_rows = np.concatenate([np.arange(lo + w, hi, L.WARPS_PER_BLOCK)
                                for lo, hi in ranges
                                for w in range(L.WARPS_PER_BLOCK)])
    np.testing.assert_array_equal(np.sort(warp_rows), np.arange(rows))
    assert plan.grid <= sms * min(blocks_per_sm, L.BLOCKS_PER_SM)
    assert plan.grid <= -(-rows // L.WARPS_PER_BLOCK)
    assert plan.workspace_floats == plan.grid * 2 * 768


@pytest.mark.parametrize("cols", [1, 44, 48, 512, 768, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
def test_shared_memory_holds_the_ring_and_the_sums(cols, dtype, aligned):
    plan = L.ln_bwd_plan(3000, cols, dtype, aligned, 132, 1)
    elt = torch.finfo(dtype).bits // 8
    sums = L.WARPS_PER_BLOCK * 2 * cols * 4
    ring = L.WARPS_PER_BLOCK * plan.depth * 2 * cols * elt
    assert plan.smem_bytes == max(ring, sums) <= KERNEL_MAX_SMEM
    if plan.vector:
        assert 2 <= plan.depth <= L.MAX_DEPTH
        assert ring <= max(L.RING_BYTES, L.WARPS_PER_BLOCK * 2 * 2 * cols * elt)


def test_train_shapes_plan():
    enc = L.ln_bwd_plan(16 * 192, 512, torch.bfloat16, True, 132, 1)
    dec = L.ln_bwd_plan(16 * 448, 768, torch.bfloat16, True, 132, 1)
    assert (enc.grid, enc.rows_per_block, enc.depth) == (128, 24, 4)
    assert (dec.grid, dec.rows_per_block, dec.depth) == (131, 55, 4)


def _replay(x, gamma, dy, plan, eps=1e-6):
    """The kernel's sums in its order, numpy float32: per warp its rows in
    order, per block its warps in order, then the column pass's groups of
    every groups-th partial row in order, the groups in order."""
    f = np.float32
    rows, c = x.shape
    dx = np.empty_like(x)
    partial = np.zeros((plan.grid, 2, c), f)
    for b, (lo, hi) in enumerate(_ranges(plan, rows)):
        warps = np.zeros((L.WARPS_PER_BLOCK, 2, c), f)
        for w in range(L.WARPS_PER_BLOCK):
            for r in range(lo + w, hi, L.WARPS_PER_BLOCK):
                xr, dyr = x[r], dy[r]
                mean = f(xr.sum(dtype=f) / f(c))
                mean2 = f((xr * xr).sum(dtype=f) / f(c))
                rstd = f(1 / np.sqrt(max(mean2 - mean * mean, f(0)) + f(eps)))
                xhat = (xr - mean) * rstd
                g = dyr * gamma
                s1 = f((g * xhat).sum(dtype=f) / f(c))
                s0 = f(g.sum(dtype=f) / f(c))
                dx[r] = rstd * (g - xhat * s1 - s0)
                warps[w, 0] += dyr * xhat
                warps[w, 1] += dyr
        for w in range(L.WARPS_PER_BLOCK):
            partial[b] += warps[w]
    groups = 16
    while groups > plan.grid:
        groups //= 2
    out = np.zeros((2, c), f)
    for grp in range(groups):
        t = np.zeros((2, c), f)
        for part in range(grp, plan.grid, groups):
            t += partial[part]
        out += t
    return dx, out[0], out[1]


@pytest.mark.parametrize("rows,c,sms", [(3, 48, 132), (333, 44, 132),
                                        (640, 64, 13), (1000, 32, 132)])
def test_kernel_order_replay_matches_plain_and_pallas(rows, c, sms):
    rng = np.random.RandomState(rows + c)
    x = (rng.randn(rows, c) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    dy = rng.randn(rows, c).astype(np.float32)
    plan = L.ln_bwd_plan(rows, c, torch.float32, True, sms, 1)
    got = _replay(x, gamma, dy, plan)
    plain = L.layer_norm_backward_plain(*(torch.from_numpy(a)
                                          for a in (x, gamma, dy)))
    _, vjp = jax.vjp(lambda x_, g_, b_: fused_layer_norm(x_, g_, b_, 1e-6,
                                                         True),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    pallas = vjp(jnp.asarray(dy))
    for name, g, p, j in zip(("dx", "dgamma", "dbeta"), got, plain, pallas):
        np.testing.assert_allclose(g, p.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(g, np.asarray(j), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_trace_stamps_name_the_kernel_stamps():
    src = CU.read_text()
    assert "constexpr int kTraceStamps = %d;" % len(L.TRACE_STAMPS) in src
    assert L.TRACE_STAMPS[0] == "start" and L.TRACE_STAMPS[-1] == "end"
