"""The LayerNorm kernels' launch plan and summation orders, on the CPU.

paddle_tpu_torch/ops/kernels/csrc/layer_norm_{fwd,bwd}.cu run only on the
card (chip_smoke.py holds them against the plain versions there). Here:

- ``_ln_plan``, the pure function that picks their launch, is checked
  over the shapes the kernels take, and against the constants of
  ``csrc/layer_norm.cuh`` (the instances the C entries hold);
- the kernels' summation orders are mirrored in numpy f32 arithmetic
  (lane-strided partial sums, the xor-shuffle tree, warp-order block
  sums, per-lane column accumulators over a warp's rows, the block's
  warp-order combine and the sliced column sum) and held against the
  Pallas kernels they replace, in interpret mode, and against an f64
  reference, under the tolerances chip_smoke.py holds the kernels to
  (``TOL``/``BWD_TOL`` for ``ln``).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.ops.kernels import layer_norm as tln

# chip_smoke.py's TOL / BWD_TOL for ("ln", dtype), "stat", "ln_cols_rel"
FWD_TOL = {"float32": 1e-4, "bfloat16": 6.25e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
STAT_TOL = 1e-4
COLS_REL_TOL = 5e-5
EPS = 1e-5
F32 = np.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_CUH = os.path.join(os.path.dirname(tln.__file__), "csrc", "layer_norm.cuh")


# --------------------------------------------------------------- the plan

@pytest.mark.parametrize("rows", [1, 4, 512, 8192])
@pytest.mark.parametrize("cols", [1, 40, 99, 300, 768, 1024, 1025, 4096,
                                  8192, 16384])
def test_plan_holds_the_row_and_fits_the_grid(rows, cols):
    for dtype, pack in ((torch.float32, 4), (torch.bfloat16, 8)):
        for aligned in (True, False):
            for backward in (False, True):
                p = tln._ln_plan(rows, cols, dtype, aligned, backward)
                assert p.k in tln._K_LADDER
                assert p.values_per_lane == p.k * p.vec <= tln._MAX_PER_LANE
                # each tier's values per lane hold the row
                assert p.values_per_lane * 32 * p.team_warps >= cols
                assert (p.tier == "warp") == (cols <= 1024)
                if p.tier == "warp":
                    assert p.team_warps == 1
                    assert p.threads == 32 * tln._ROW_WARPS
                    need = -(-rows // tln._ROW_WARPS)
                else:
                    # the block tier's instances: more than half a lane
                    assert 2 * p.values_per_lane > tln._MAX_PER_LANE
                    assert p.threads == 32 * p.team_warps <= 512
                    need = rows
                # the smallest rung that holds the row
                smaller = [r for r in tln._K_LADDER if r < p.k]
                assert not smaller or \
                    smaller[-1] * p.vec * 32 * p.team_warps < cols
                # 16-byte packs only on aligned pointers and whole packs
                if aligned and cols % pack == 0:
                    assert p.vec == pack
                else:
                    assert p.vec == 1
                assert 1 <= p.grid <= need
                assert p.partial_rows == (p.grid if backward else 0)


def test_plan_fills_the_card_at_the_main_paths_shapes():
    f = tln._ln_plan(8192, 768, torch.float32, True)
    b = tln._ln_plan(8192, 768, torch.float32, True, backward=True)
    assert (f.tier, f.vec, f.k, f.grid) == ("warp", 4, 6, 2 * 132)
    assert (b.tier, b.vec, b.k, b.grid, b.partial_rows) == \
        ("warp", 4, 6, 132, 132)
    h = tln._ln_plan(4096, 768, torch.bfloat16, True, sms=114)
    assert (h.vec, h.k, h.grid) == (8, 3, 2 * 114)
    hb = tln._ln_plan(4096, 768, torch.bfloat16, True, True)
    assert (hb.grid, hb.partial_rows) == (132, 132)
    assert tln._ln_plan(1, 768, torch.float32, True, True).grid == 1
    with pytest.raises(ValueError, match="16384"):
        tln._ln_plan(4, 16385, torch.float32, True)


def test_plan_constants_match_the_cuda_header():
    src = open(_CUH).read()

    def const(name):
        return int(re.search(r"constexpr int %s = ([0-9 *]+);" % name,
                             src).group(1).replace(" ", "").split("*")[-1])
    assert const("kMaxPerLane") == tln._MAX_PER_LANE
    assert const("kRowWarps") == tln._ROW_WARPS
    assert const("kMaxTeam") == 32 * tln._MAX_TEAM_WARPS
    assert const("kMaxCols") == 32 * tln._MAX_TEAM_WARPS * \
        tln._MAX_PER_LANE
    ladder = re.search(r"#define PTT_LN_FOR_EACH_K\(X\) (.*)", src).group(1)
    assert tuple(int(k) for k in re.findall(r"X\((\d+)\)", ladder)) == \
        tln._K_LADDER


# ----------------------------------------------------- the summation orders

def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift
            ).astype(F32)


def _bf16(a):
    """Round f32 values to bf16, back as f32 (the card's inputs)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _lanes(plan, cols):
    """Column index of each (thread, pack, value) of a row's team, and
    whether it lies in the row: pack j of thread t covers columns
    (j * team + t) * vec ... + vec - 1."""
    team = 32 * plan.team_warps
    t = np.arange(team)[:, None, None]
    j = np.arange(plan.k)[None, :, None]
    e = np.arange(plan.vec)[None, None, :]
    idx = (j * team + t) * plan.vec + e
    return np.minimum(idx, cols - 1), idx < cols


def _team_sum(part, plan):
    """Sum of the threads' partials (..., team): the xor-shuffle tree in
    each warp, then the warps in order (the block tier's shared memory)."""
    lead = part.shape[:-1]
    w = part.reshape(lead + (plan.team_warps, 32))
    for o in (16, 8, 4, 2, 1):
        w = (w + w[..., np.arange(32) ^ o]).astype(F32)
    total = np.zeros(lead, F32)
    for i in range(plan.team_warps):
        total = (total + w[..., i, 0]).astype(F32)
    return total


def _thread_sums(terms, ok):
    """Each thread's partial sum of terms (rows, team, k, vec): packs in
    order, values in order in a pack, past-the-row values left out."""
    s = np.zeros(terms.shape[:2], F32)
    for j in range(terms.shape[2]):
        for e in range(terms.shape[3]):
            s = np.where(ok[None, :, j, e], s + terms[:, :, j, e], s
                         ).astype(F32)
    return s


def _mirror_fwd(x, scale, bias, plan):
    """layer_norm_fwd.cu's arithmetic in f32: y (f32, before the cast to
    x's dtype), mean, rstd."""
    cols = x.shape[1]
    idx, ok = _lanes(plan, cols)
    v = np.where(ok, x[:, idx], F32(0))                 # (rows, team, k, v)
    n = F32(cols)
    mean = (_team_sum(_thread_sums(v, ok), plan) / n).astype(F32)
    d = (v - mean[:, None, None, None]).astype(F32)
    var = (_team_sum(_thread_sums((d * d).astype(F32), ok), plan) / n
           ).astype(F32)
    rstd = (F32(1) / np.sqrt(var + F32(EPS))).astype(F32)
    t = ((d * rstd[:, None, None, None]).astype(F32) * scale[idx]
         ).astype(F32)
    t = (t + bias[idx]).astype(F32)
    y = np.zeros_like(x)
    y[:, idx[ok]] = t[:, ok]
    return y, mean, rstd


def _walk(plan, rows):
    """For each team (warp or block) the rows it walks, in order: the
    persistent grid's teams take rows r, r + teams, ... ."""
    teams = plan.grid * (tln._ROW_WARPS if plan.tier == "warp" else 1)
    return teams, [np.arange(w, rows, teams) for w in range(teams)]


def _mirror_bwd(x, g, scale, mean, rstd, plan):
    """layer_norm_bwd.cu's arithmetic in f32: dx (f32, before the cast),
    dscale, dbias."""
    rows, cols = x.shape
    idx, ok = _lanes(plan, cols)
    xv = np.where(ok, x[:, idx], F32(0))
    gv = np.where(ok, g[:, idx], F32(0))
    xh = np.where(ok, ((xv - mean[:, None, None, None]).astype(F32) *
                       rstd[:, None, None, None]).astype(F32), F32(0))
    gs = (gv * scale[idx]).astype(F32)
    n = F32(cols)
    mg = (_team_sum(_thread_sums(gs, ok), plan) / n).astype(F32)
    mgx = (_team_sum(_thread_sums((gs * xh).astype(F32), ok), plan) / n
           ).astype(F32)
    t = ((gs - mg[:, None, None, None]).astype(F32) -
         (xh * mgx[:, None, None, None]).astype(F32)).astype(F32)
    t = (rstd[:, None, None, None] * t).astype(F32)
    dx = np.zeros_like(x)
    dx[:, idx[ok]] = t[:, ok]
    # per-team column accumulators over the team's rows, in row order
    ds_terms = (g * ((x - mean[:, None]) * rstd[:, None]).astype(F32)
                ).astype(F32)
    teams, walks = _walk(plan, rows)
    ds_t = np.zeros((teams, cols), F32)
    db_t = np.zeros((teams, cols), F32)
    for w, walk in enumerate(walks):
        for r in walk:
            ds_t[w] = (ds_t[w] + ds_terms[r]).astype(F32)
            db_t[w] = (db_t[w] + g[r]).astype(F32)
    if plan.tier == "warp":            # the block's warps, in order
        ds_p = ds_t.reshape(plan.grid, tln._ROW_WARPS, cols)
        db_p = db_t.reshape(plan.grid, tln._ROW_WARPS, cols)
        ds_part, db_part = ds_p[:, 0].copy(), db_p[:, 0].copy()
        for i in range(1, tln._ROW_WARPS):
            ds_part = (ds_part + ds_p[:, i]).astype(F32)
            db_part = (db_part + db_p[:, i]).astype(F32)
    else:
        ds_part, db_part = ds_t, db_t
    return dx, _colsum(ds_part), _colsum(db_part)


def _colsum(part, slices=32):
    """ln_bwd_colsum_kernel: slice i sums partial rows i, i + 32, ... in
    order, then the slices meet in a fixed pairwise tree."""
    sl = []
    for i in range(slices):
        s = np.zeros(part.shape[1], F32)
        for p in range(i, part.shape[0], slices):
            s = (s + part[p]).astype(F32)
        sl.append(s)
    h = slices // 2
    while h:
        for i in range(h):
            sl[i] = (sl[i] + sl[i + h]).astype(F32)
        h //= 2
    return sl[0]


def _inputs(rows, cols, dtype, seed=0):
    x = _rand((rows, cols), seed, 3.0, 1.0)
    g = _rand((rows, cols), seed + 3)
    if dtype == "bfloat16":
        x, g = _bf16(x), _bf16(g)
    scale = _rand((cols,), seed + 1, 0.25, 1.0)
    bias = _rand((cols,), seed + 2)
    return x, g, scale, bias


def _ref64(x, g, scale, bias):
    x64, g64 = x.astype(np.float64), g.astype(np.float64)
    mean = x64.mean(-1)
    xc = x64 - mean[:, None]
    rstd = 1.0 / np.sqrt((xc * xc).mean(-1) + EPS)
    xh = xc * rstd[:, None]
    y = xh * scale + bias
    gs = g64 * scale
    dx = rstd[:, None] * (gs - gs.mean(-1, keepdims=True) -
                          xh * (gs * xh).mean(-1, keepdims=True))
    return y, mean, rstd, dx, (g64 * xh).sum(0), g64.sum(0)


def _out(a, dtype):
    """The kernel's output rounding: f32 as is, bf16 rounded once."""
    return a if dtype == "float32" else _bf16(a)


def _fwd_err(y, mean, rstd, want):
    return (float(np.abs(y - np.asarray(want[0], np.float64)).max()),
            max(float(np.abs(mean - np.asarray(want[1])).max()),
                float(np.abs(rstd - np.asarray(want[2])).max())))


SHAPES = [(512, 768), (37, 300), (8, 40), (6, 2000)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_forward_order_matches_pallas_and_f64(rows, cols, dtype, aligned):
    x, _, scale, bias = _inputs(rows, cols, dtype)
    plan = tln._ln_plan(rows, cols, DTYPES[dtype], aligned)
    y, mean, rstd = _mirror_fwd(x, scale, bias, plan)
    y = _out(y, dtype)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    pallas = jln._ln_call_fwd(jx, jnp.asarray(scale), jnp.asarray(bias),
                              EPS, 8, True)
    pallas = (np.asarray(pallas[0]).astype(F32), pallas[1], pallas[2])
    y64, m64, r64 = _ref64(x, x, scale, bias)[:3]
    for want in (pallas, (y64, m64, r64)):
        err, stat_err = _fwd_err(y, mean, rstd, want)
        assert err <= FWD_TOL[dtype], (plan, err)
        # rstd up to ~1/3 here: relative and absolute agree
        assert stat_err <= STAT_TOL, (plan, stat_err)
    # and against the port's own plain version (the card's oracle)
    plain = tln.layer_norm_plain(torch.from_numpy(x).to(DTYPES[dtype]),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(bias), EPS)
    err, stat_err = _fwd_err(y, mean, rstd,
                             [t.float().numpy() for t in plain])
    assert err <= FWD_TOL[dtype] and stat_err <= STAT_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_backward_order_matches_pallas_and_f64(rows, cols, dtype, aligned):
    x, g, scale, bias = _inputs(rows, cols, dtype, seed=4)
    plan = tln._ln_plan(rows, cols, DTYPES[dtype], aligned, backward=True)
    _, mean, rstd = _mirror_fwd(x, scale, bias,
                                tln._ln_plan(rows, cols, DTYPES[dtype],
                                             aligned))
    dx, dscale, dbias = _mirror_bwd(x, g, scale, mean, rstd, plan)
    dx = _out(dx, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fn = lambda x_, s_, b_: jln.fused_layer_norm(  # noqa: E731
        x_, s_, b_, EPS, block_rows=8, interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(x).astype(jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    pallas = [np.asarray(a).astype(np.float64)
              for a in vjp(jnp.asarray(g).astype(jdt))]
    ref = _ref64(x, g, scale, bias)[3:]
    for want in (pallas, ref):
        assert float(np.abs(dx - want[0]).max()) <= BWD_TOL[dtype], plan
        for got, w in ((dscale, want[1]), (dbias, want[2])):
            rel = float(np.abs(got - w).max()) / max(1.0,
                                                     float(np.abs(w).max()))
            assert rel <= COLS_REL_TOL, (plan, rel)


def test_column_sums_do_not_depend_on_the_walk_beyond_rounding():
    """Two grids walk the rows in other orders: the column sums differ
    only by f32 rounding (so the card's bits depend on the plan alone,
    and the plan on the shape and the card's SM count)."""
    x, g, scale, bias = _inputs(512, 768, "float32", seed=9)
    mean = x.mean(-1).astype(F32)
    rstd = (1 / np.sqrt(((x - mean[:, None]) ** 2).mean(-1) + EPS)
            ).astype(F32)
    a = _mirror_bwd(x, g, scale, mean, rstd,
                    tln._ln_plan(512, 768, torch.float32, True, True))
    b = _mirror_bwd(x, g, scale, mean, rstd,
                    tln._ln_plan(512, 768, torch.float32, True, True, sms=7))
    assert np.array_equal(a[0], b[0])           # dx: per row, same order
    for u, v in zip(a[1:], b[1:]):
        assert float(np.abs(u - v).max()) <= 1e-5 * float(np.abs(v).max())
