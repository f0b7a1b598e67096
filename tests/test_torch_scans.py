"""K1 ``scan``'s entry points, ``Field.prefix_product`` and
``Field.affine_scan``, against the JAX package's ``utils/scans.py``
(``hillis_scan`` / ``affine_scan`` over its ``Field.mont_mul`` / ``add``,
run under ``jax.disable_jit()``: no XLA compile), limb for limb (tolerance
0), on the CPU; and a plain-torch model of the CUDA kernel's decomposition
(``csrc/field_kernels.cu`` ``field_scan_kernel``: tiles of threads x items,
a serial run per thread, shuffle scans across warps, the warp totals on one
thread, decoupled look-back over a window of earlier tiles) at small tile,
warp and window sizes against the Hillis-Steele loops, so that an index or
boundary fault shows before the card."""

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


def kernel_model(xs, combine, ident, threads, items, warp, window, lag):
    """The kernel's grouping of the combines over scan positions 0..n-1 (xs:
    one tuple of (18, 1) tensors each), with tiles of threads x items
    elements, warps of `warp` threads and look-back windows of `window`
    tiles. Tile t sees the inclusive prefix of tile k < t published only if
    t - k >= lag (tile 0's always), else its total - so the look-back runs
    through several windows and stops at the nearest inclusive prefix."""
    n, tile = len(xs), threads * items
    totals, inclusive, out = {}, {}, [None] * n
    for t in range(-(-n // tile)):
        x = [xs[t * tile + e] if t * tile + e < n else ident for e in range(tile)]
        runs = []
        for th in range(threads):  # each thread's run, inclusive
            loc = [x[th * items]]
            for j in range(1, items):
                loc.append(combine(loc[-1], x[th * items + j]))
            runs.append(loc)
        inc = [loc[-1] for loc in runs]
        d = 1
        while d < warp:  # shuffle-up scan within each warp
            inc = [combine(inc[th - d], inc[th]) if th % warp >= d else inc[th] for th in range(threads)]
            d *= 2
        lane_ex = [ident if th % warp == 0 else inc[th - 1] for th in range(threads)]
        warp_ex, acc = [], None  # one thread over the warp totals
        for w in range(threads // warp):
            warp_ex.append(acc if acc is not None else ident)
            wt = inc[w * warp + warp - 1]
            acc = wt if acc is None else combine(acc, wt)
        totals[t] = acc
        excl, look = ident, t - 1
        while t > 0:
            ks = [look - lane for lane in range(window)]
            is_inc = [k < 0 or k == 0 or t - k >= lag for k in ks]
            stop = is_inc.index(True) if any(is_inc) else window - 1
            v = [(inclusive[k] if is_inc[lane] else totals[k]) if k >= 0 and lane <= stop else ident
                 for lane, k in enumerate(ks)]
            d = 1
            while d < window:  # shuffle-down fold: lane l holds a later tile than lane l + 1
                v = [combine(v[lane + d], v[lane]) if lane + d < window else v[lane] for lane in range(window)]
                d *= 2
            excl = combine(v[0], excl)
            if any(is_inc):
                break
            look -= window
        inclusive[t] = totals[t] if t == 0 else combine(excl, totals[t])
        for th in range(threads):
            pre = combine(combine(excl, warp_ex[th // warp]), lane_ex[th])
            for j in range(items):
                pos = t * tile + th * items + j
                if pos < n:
                    out[pos] = combine(pre, runs[th][j])
    return out


@pytest.mark.parametrize("lag", [1, 3])
@pytest.mark.parametrize("n", [1, 5, 8, 9, 13, 29])
@pytest.mark.parametrize("mode", ["prefix", "suffix", "affine"])
def test_kernel_model_matches_hillis(mode, n, lag):
    """Tiles of 8 (4 threads x 2 items, warps of 2, windows of 2 tiles):
    n below a tile, one tile, a tile + 1, ragged and four tiles deep."""
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
    got = kernel_model(xs, combine, ident, threads=4, items=2, warp=2, window=2, lag=lag)
    if mode == "suffix":
        got = got[::-1]
    assert torch.equal(torch.cat([g[-1] for g in got], dim=1), want)


def test_kernel_constants_match_the_source():
    """The wrapper's tile and state size are the kernel's."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(field_kernels.__file__), "..", "csrc", "field_kernels.cu")).read()
    threads = int(re.search(r"#define SCAN_THREADS (\d+)", src).group(1))
    items = int(re.search(r"#define SCAN_ITEMS (\d+)", src).group(1))
    assert threads * items == field_kernels.SCAN_TILE
    assert field_kernels.SCAN_WORDS_PER_TILE == 1 + 4 * 9
