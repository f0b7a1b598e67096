"""K1 ``scan``'s entry points, ``Field.prefix_product`` and
``Field.affine_scan``, against the JAX package's ``utils/scans.py``
(``hillis_scan`` / ``affine_scan`` over its ``Field.mont_mul`` / ``add``,
run under ``jax.disable_jit()``: no XLA compile), limb for limb (tolerance
0), on the CPU; and a plain-torch model of the CUDA kernel's decomposition
(``csrc/field_kernels.cu`` ``field_scan_kernel``: the plan ``scan_plan``
picks - one warp, one CTA, or tiles of threads x items chained by a
decoupled look-back whose lanes fold several earlier tiles - a serial run
per thread, shuffle scans across each warp and across the warp totals, and
the state the last CTA leaves zero) at small tile, warp and window sizes
against the Hillis-Steele loops, so that an index or boundary fault shows
before the card; and the plans taken at the card's sizes."""

import jax
import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.utils import scans as jscans

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fr as tfr
from barretenberg_tpu_torch.fields.params import FR_PARAMS
from barretenberg_tpu_torch.kernels import field_kernels
from barretenberg_tpu_torch.utils import scans

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

P = jfr.p
SIZES = (1, 2, 3, 17, 64)


def _values(n, seed, zero_at=None):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    if zero_at is not None and zero_at < n:
        vals[zero_at] = 0
    return vals


def _same(t, j) -> bool:
    return np.array_equal(convert.field_array(t), np.asarray(j))


@pytest.mark.parametrize("n", SIZES)
def test_prefix_product_matches_jax(n):
    """Both directions, with a zero entry (batch_invert's zero lanes)."""
    ja = jfr.encode(_values(n, 40 + n, zero_at=n // 2))
    ta = convert.field_tensor(ja, "cpu")
    f = tfr("cpu")
    with jax.disable_jit():
        for reverse in (False, True):
            want = jscans.hillis_scan(jfr.mont_mul, ja, axis=1, reverse=reverse)
            assert _same(f.prefix_product(ta, 1, reverse), want)


@pytest.mark.parametrize("n", SIZES)
def test_affine_scan_matches_jax(n):
    """A full m, and the Kate division's broadcast m (its first lane is
    never read, so the JAX side's one there gives the same d)."""
    jm, jb = jfr.encode(_values(n, 50 + n)), jfr.encode(_values(n, 60 + n, zero_at=1))
    tm, tb = convert.field_tensor(jm, "cpu"), convert.field_tensor(jb, "cpu")
    f = tfr("cpu")
    jw = jfr.encode(_values(1, 70 + n))
    jm_kate = np.concatenate([np.asarray(jfr.one).reshape(18, 1), np.repeat(np.asarray(jw), n - 1, axis=1)], axis=1)
    with jax.disable_jit():
        assert _same(f.affine_scan(tm, tb, 1), jscans.affine_scan(jfr.mont_mul, jfr.add, jm, jb, axis=1))
        want = jscans.affine_scan(jfr.mont_mul, jfr.add, jm_kate[:, :n], jb, axis=1)
    assert _same(f.affine_scan(convert.field_tensor(jw, "cpu"), tb, 1), want)


def test_scan_batches_and_counts():
    """A batch scanned along a middle dim equals its rows scanned one by
    one; the CPU takes the plain version and never counts a launch."""
    f = tfr("cpu")
    a = f.encode(_values(3 * 2 * 5, 80)).reshape(18, 3, 2, 5)
    before = field_kernels.launch_counts["scan"]
    for reverse in (False, True):
        got = f.prefix_product(a, 2, reverse)
        for i in range(3):
            for k in range(5):
                assert torch.equal(got[:, i, :, k], f.prefix_product(a[:, i, :, k], 1, reverse))
    assert field_kernels.launch_counts["scan"] == before


# ---------------------------------------------------------------------------
# A model of the kernel's decomposition
# ---------------------------------------------------------------------------
def _prod_ops(lf):
    return (lambda f, s: (lf.mont_mul(s[0], f[0]),)), (lf.const_rows(1, torch.zeros((18, 1), dtype=torch.int32)),)


def _affine_ops(lf):
    def combine(f, s):
        return lf.mont_mul(s[0], f[0]), lf.add(lf.mont_mul(s[0], f[1]), s[1])

    one = lf.const_rows(1, torch.zeros((18, 1), dtype=torch.int32))
    return combine, (one, torch.zeros_like(one))


def _kogge_stone(vals, combine, width, levels_to):
    """Each `width`-lane group's inclusive scan by shuffles-up of d < levels_to."""
    d = 1
    while d < levels_to:
        vals = [combine(vals[i - d], vals[i]) if i % width >= d else vals[i] for i in range(len(vals))]
        d *= 2
    return vals


def _look_back(t, inclusive, totals, combine, ident, warp, look_items, lag):
    """scan_look_back: what precedes tile t > 0 of a row. Lane L folds the
    `per` tiles below look - L per (nearest first, stopping at a visible
    inclusive prefix or the row's start); lanes past the first that stopped
    take the identity; the lanes fold by shuffles-down of d <= first. Tile
    k's inclusive prefix is visible to tile t only if t - k >= lag (tile
    0's always), so a look-back may run over several windows."""
    excl, look, steps = ident, t - 1, 0
    while True:
        steps += 1
        per = min((look + warp) // warp, look_items)
        v, stop = [], []
        for lane in range(warp):
            acc, st = ident, False
            for j in range(per):
                k = look - lane * per - j
                if k < 0:
                    st = True
                    break
                visible = k == 0 or t - k >= lag
                acc = combine(inclusive[k] if visible else totals[k], acc)
                if visible:
                    st = True
                    break
            v.append(acc)
            stop.append(st)
        first = stop.index(True) if any(stop) else warp - 1
        v = [x if lane <= first else ident for lane, x in enumerate(v)]
        d = 1
        while d <= first:
            v = [combine(v[lane + d], v[lane]) if lane + d < warp else v[lane] for lane in range(warp)]
            d *= 2
        excl = combine(v[0], excl)
        if any(stop):
            return excl, steps
        look -= warp * per


def kernel_model(xs, combine, ident, plan, warp, look_items, lag, state):
    """field_scan_kernel's grouping of the combines over scan positions
    0..n-1 of one row (xs: one tuple of (18, 1) tensors each) for a plan
    (threads, items, tiles) of scan_plan: tiles of threads x items elements,
    warps of `warp` lanes, look-back lanes of `look_items` tiles. `state` is
    the stream's cached state buffer (next tile, CTAs done, a flag a tile),
    shared by the launches in stream order: every word a launch uses must
    be zero when it starts, and the last CTA clears them. Returns the
    outputs and the most look-back steps a tile took."""
    n = len(xs)
    threads, items, tiles = plan
    tile, nwarps = threads * items, threads // warp
    if tiles > 1:
        assert len(state) >= 2 + tiles and not any(state[: 2 + tiles])
    totals, inclusive, out, steps = {}, {}, [None] * n, 0
    for t in range(tiles):
        state[0] += tiles > 1
        first = t * tile
        x = [xs[first + e] if first + e < n else ident for e in range(tile)]
        runs = []
        for th in range(threads):  # each thread's run, inclusive
            loc = [x[th * items]]
            for j in range(1, items):
                loc.append(combine(loc[-1], x[th * items + j]))
            runs.append(loc)
        live = -(-(n - first) // items)
        levels_to = live if nwarps == 1 and live < warp else warp
        inc = _kogge_stone([loc[-1] for loc in runs], combine, warp, levels_to)
        lane_ex = [ident if th % warp == 0 else inc[th - 1] for th in range(threads)]
        wt = _kogge_stone([inc[w * warp + warp - 1] for w in range(nwarps)], combine, warp, nwarps)
        wex = [ident] + wt[:-1]
        excl = ident
        if tiles > 1:
            totals[t] = wt[-1]
            state[2 + t] = 1
            if t > 0:
                excl, k = _look_back(t, inclusive, totals, combine, ident, warp, look_items, lag)
                steps = max(steps, k)
            inclusive[t] = totals[t] if t == 0 else combine(excl, totals[t])
            state[2 + t] = 2
        for th in range(threads):
            pre = combine(combine(excl, wex[th // warp]), lane_ex[th])
            for j in range(items):
                pos = first + th * items + j
                if pos < n:
                    out[pos] = combine(pre, runs[th][j])
        if tiles > 1:
            state[1] += 1
            if state[1] == tiles:  # the last CTA clears the words it used
                state[: 2 + tiles] = [0] * (2 + tiles)
    return out, steps


# reduced sizes: warps of 2 lanes, CTAs of 4 threads, 1-2 items a thread,
# look-back lanes of 2 tiles (a window of 4 tiles)
SMALL = {"threads": 4, "warp": 2, "max_items": 2}
SMALL_LOOK = 2


def _model_case(mode, n, sms, lag):
    lf = field_kernels.limb_field(FR_PARAMS)
    f = tfr("cpu")
    a = f.encode(_values(n, 90 + n, zero_at=n // 2))
    b = f.encode(_values(n, 100 + n))
    if mode == "affine":
        combine, ident = _affine_ops(lf)
        xs = [(a[:, i : i + 1], b[:, i : i + 1]) for i in range(n)]
        want = scans.affine_scan(lf.mont_mul, lf.add, a, b, 1)
    else:
        combine, ident = _prod_ops(lf)
        order = range(n - 1, -1, -1) if mode == "suffix" else range(n)
        xs = [(a[:, i : i + 1],) for i in order]
        want = scans.hillis_scan(lf.mont_mul, a, 1, reverse=mode == "suffix")
    plan = field_kernels.scan_plan(1, n, sms, **SMALL)
    state = [0] * 64
    for launch in range(2):  # the same scan again on the state the first left
        got, steps = kernel_model(xs, combine, ident, plan, SMALL["warp"], SMALL_LOOK, lag, state)
        if mode == "suffix":
            got = got[::-1]
        assert torch.equal(torch.cat([g[-1] for g in got], dim=1), want), launch
        assert not any(state)
    return plan, steps


@pytest.mark.parametrize("lag", [1, 3])
@pytest.mark.parametrize("n", [1, 5, 8, 9, 13, 29])
@pytest.mark.parametrize("mode", ["prefix", "suffix", "affine"])
def test_kernel_model_matches_hillis(mode, n, lag):
    """At reduced sizes (warps of 2, CTAs of 4 threads of 1-2 items, 8
    SMs): n in one warp, in one CTA (with its tile filled), past it in
    tiles of 4 (all fit on the SMs at once) and of 8."""
    plan, _ = _model_case(mode, n, 8, lag)
    assert plan[2] == 1 if n <= 8 else plan[1] == (1 if n <= 32 else 2)


@pytest.mark.parametrize("lag", [1, 2, 5])
@pytest.mark.parametrize("n, sms", [(33, 64), (70, 64), (70, 8)])
@pytest.mark.parametrize("mode", ["prefix", "suffix", "affine"])
def test_kernel_model_look_back_windows(mode, n, sms, lag):
    """Rows of 9 and 18 tiles of 4 (on 64 SMs) and of 9 tiles of 8 (on 8
    SMs, where 18 tiles of 4 do not fit), so that a look-back folds several
    lanes of 2 tiles and, while the nearest inclusive prefixes are not yet
    visible, runs over more than one window."""
    plan, steps = _model_case(mode, n, sms, lag)
    items = 1 if sms == 64 else 2
    assert plan == (4, items, -(-n // (4 * items)))
    if lag == 1:
        assert steps == 1
    if n == 70 and sms == 64 and lag == 5:
        assert steps >= 2


def test_kernel_model_state_across_launches():
    """Affine scans of 9, 18, 3 and 9 tiles in stream order on one state
    buffer: each finds every word it uses zero (its tiles' totals and
    prefixes live apart, so a longer launch never reads an earlier one's
    data as flags) and leaves them zero."""
    lf = field_kernels.limb_field(FR_PARAMS)
    f = tfr("cpu")
    combine, ident = _affine_ops(lf)
    state = [0] * 64
    for n in (33, 70, 9, 33):
        a, b = f.encode(_values(n, 110 + n)), f.encode(_values(n, 120 + n))
        plan = field_kernels.scan_plan(1, n, 64, **SMALL)
        got, _ = kernel_model([(a[:, i : i + 1], b[:, i : i + 1]) for i in range(n)], combine, ident, plan,
                              SMALL["warp"], SMALL_LOOK, 2, state)
        assert torch.equal(torch.cat([g[-1] for g in got], dim=1), scans.affine_scan(lf.mont_mul, lf.add, a, b, 1))
        assert not any(state)


@pytest.mark.parametrize("n, plan", [
    (1, (32, 1, 1)), (3, (32, 1, 1)), (31, (32, 1, 1)), (32, (32, 1, 1)), (33, (128, 1, 1)),
    (1023, (128, 8, 1)), (1024, (128, 8, 1)), (1025, (128, 4, 3)), (1 << 16, (128, 4, 128)),
    (1 << 18, (128, 8, 256)), (13 << 16, (128, 8, 832)),
])
def test_scan_plan(n, plan):
    """The plan K1 scan takes on a 132-SM H100 for one row: one warp up to 32
    elements, one CTA up to 1,024, then tiles of 512 while they fit on the
    SMs at once (2^16: 128 tiles) and of 1,024 beyond."""
    assert field_kernels.scan_plan(1, n, 132) == plan
    assert field_kernels.scan_scratch_words(1, plan[2]) == (2 + plan[2], 36 * plan[2])


def test_scan_plan_counts_rows():
    """Rows share the card: 3 rows of 2^15 take tiles of 512 (192 > 132
    tiles: no), so 1,024; 2 rows of 2^15 fit (128 tiles of 512)."""
    assert field_kernels.scan_plan(3, 1 << 15, 132) == (128, 8, 32)
    assert field_kernels.scan_plan(2, 1 << 15, 132) == (128, 4, 64)
    assert field_kernels.scan_plan(35, 3, 132) == (32, 1, 1)


def test_kernel_constants_match_the_source():
    """The wrapper's tile sizes and state layout are the kernel's."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(field_kernels.__file__), "..", "csrc", "field_kernels.cu")).read()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))  # noqa: E731
    assert define("SCAN_THREADS") == field_kernels.SCAN_THREADS
    assert define("SCAN_MAX_ITEMS") == field_kernels.SCAN_MAX_ITEMS
    assert define("SCAN_LOOK_ITEMS") == 4
    assert field_kernels.SCAN_DATA_WORDS_PER_TILE == 4 * 9
    assert "cudaMemsetAsync" not in src  # the state is left zero by the kernel, not cleared per call
