"""K1 ``dot`` and ``lincomb``'s entry points - the prover's batched
evaluations (``Prover._multi_eval``, ``arithmetic.evaluate_with_powers``,
``arithmetic.evaluate``) and linear combinations (``widgets.linear_combo``)
- against the JAX package's ``_multi_eval_jit``, ``evaluate_device``,
``evaluate`` and ``_linear_combo_jit``, run under ``jax.disable_jit()`` (no
XLA compile), limb for limb (tolerance 0), on the CPU; a plain-torch model
of the CUDA dot kernel's grouping (grid-stride partials per thread, warp
shuffle folds, the CTA fold through shared memory, the last CTA's fold of
every CTA's partials) at small thread, warp and CTA counts against the
tree sum; and the wrapper's constants against the source's."""

import functools
import os
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.plonk.prover import _linear_combo_jit, _multi_eval_jit
from barretenberg_tpu.polynomials import arithmetic as jarith

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fr as tfr
from barretenberg_tpu_torch.fields.params import FR_PARAMS
from barretenberg_tpu_torch.kernels import field_kernels
from barretenberg_tpu_torch.plonk.prover import Prover
from barretenberg_tpu_torch.plonk.widgets import linear_combo
from barretenberg_tpu_torch.polynomials import arithmetic

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

P = jfr.p
SIZES = (1, 2, 3, 17, 64)
# one row, the prove's five evaluations at z, and more than one launch takes
ROWS = (1, 5, field_kernels.DOT_MAX_ROWS + 1)
# one term, the widget's five, the opening's nine, more than one launch takes
TERMS = (1, 5, 9, field_kernels.LINCOMB_MAX_TERMS + 1)


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _rows(b, n, seed):
    """(18, b, n) JAX limbs, row r with a zero at lane r % n and p - 1 at the last lane."""
    vals = _values(b * n, seed)
    for r in range(b):
        vals[r * n + r % n] = 0
        vals[r * n + n - 1] = P - 1
    return np.asarray(jfr.encode(vals)).reshape(18, b, n)


def _same(t, j) -> bool:
    return np.array_equal(convert.field_array(t), np.asarray(j))


# Eager JAX compiles each primitive of a field op once per shape (seconds
# for a product), so the JAX side runs at one shape per function and the
# port at every size: a polynomial of n coefficients is evaluated by JAX
# zero-padded to WIDTH (the same value), a combination of J terms as one of
# max(TERMS) terms whose extra scalars are zero, and a combination of fewer
# lanes as the first lanes of LANES (each lane is its own combination).
WIDTH = max(SIZES)
LANES = 17


@functools.cache
def _jax_evaluations():
    """max(ROWS) rows of WIDTH coefficients (row r's lanes past its length n
    zeroed by the caller's slice), a table of 3 WIDTH elements, and the JAX
    package's evaluations over the table's first WIDTH columns: the batch
    through ``_multi_eval_jit``, the first row through ``evaluate_device``."""
    jrows = _rows(max(ROWS), WIDTH, 10)
    jtable = np.asarray(jfr.encode(_values(3 * WIDTH, 20)))
    return jrows, jtable


@functools.cache
def _jax_multi_eval(n):
    jrows, jtable = _jax_evaluations()
    padded = np.where(np.arange(WIDTH) < n, jrows, 0).astype(np.uint32)
    with jax.disable_jit():
        batch = np.asarray(_multi_eval_jit(padded, jtable[:, :WIDTH]))
        one = np.asarray(jarith.evaluate_device(padded[:, 0], jtable[:, :WIDTH]))
    return batch, one


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("n", SIZES)
def test_multi_eval_matches_jax(n, b):
    """``_multi_eval`` (one ``dot`` per batch of up to DOT_MAX_ROWS rows)
    against ``_multi_eval_jit``, its table longer than the rows (the prove's
    3n table read over n), and the first row's ``evaluate_with_powers``
    against ``evaluate_device``."""
    jrows, jtable = _jax_evaluations()
    batch, one = _jax_multi_eval(n)
    f = tfr("cpu")
    rows = [convert.field_tensor(jrows[:, r, :n], "cpu") for r in range(b)]
    table = convert.field_tensor(jtable[:, : 3 * n], "cpu")
    got = Prover._multi_eval(SimpleNamespace(fr=f), rows, table)
    assert got == f.decode(convert.field_tensor(batch[:, :b], "cpu"))
    assert _same(f.dot(rows, table[:, :n]), batch[:, :b])
    assert _same(arithmetic.evaluate_with_powers(f, rows[0], table), one)


@pytest.mark.parametrize("n", SIZES)
def test_evaluate_matches_jax(n):
    coeffs = _rows(1, WIDTH, 30)[:, 0]
    z = _values(1, 40)[0]
    with jax.disable_jit():
        want = jarith.evaluate(np.where(np.arange(WIDTH) < n, coeffs, 0).astype(np.uint32), z)
    assert arithmetic.evaluate(convert.field_tensor(coeffs[:, :n], "cpu"), z) == want


@functools.cache
def _jax_linear_combo(j):
    """The JAX combination of the first j of max(TERMS) polys of LANES lanes
    (the rest with scalar 0), and those polys and scalars; scalars 0, 1 and
    p - 1 first."""
    jpolys = _rows(max(TERMS), LANES, 50)
    scalars = _values(max(TERMS), 60)
    scalars[:3] = [0, 1, P - 1]
    padded = scalars[:j] + [0] * (max(TERMS) - j)
    with jax.disable_jit():
        want = np.asarray(_linear_combo_jit(jpolys, jfr.encode(padded)))
    return jpolys, scalars[:j], want


@pytest.mark.parametrize("n", (1, LANES))
@pytest.mark.parametrize("j", TERMS)
def test_linear_combo_matches_jax(j, n):
    """``linear_combo`` (one ``lincomb`` per LINCOMB_MAX_TERMS terms)
    against ``_linear_combo_jit``; the last term a strided view, as the
    opening's quotient slices are."""
    jpolys, scalars, want = _jax_linear_combo(j)
    wide = convert.field_tensor(np.concatenate([jpolys[:, j - 1, :n], jpolys[:, j - 1, :n]], axis=1), "cpu")
    polys = [convert.field_tensor(jpolys[:, r, :n], "cpu") for r in range(j - 1)] + [wide[:, :n]]
    assert _same(linear_combo(tfr("cpu"), list(zip(polys, scalars))), want[:, :n])


def test_cpu_path_counts_no_launch():
    f = tfr("cpu")
    rows = [f.encode(_values(5, 70 + r)) for r in range(3)]
    before = dict(field_kernels.launch_counts)
    f.dot(rows, rows[0])
    f.linear_combination(rows, [1, 2, 3])
    assert field_kernels.launch_counts == before


# ---------------------------------------------------------------------------
# A model of the dot kernel's grouping
# ---------------------------------------------------------------------------
def dot_model(prods, add, zero, threads, warp, ctas):
    """The kernel's grouping of one row's sums over lanes 0..n-1 (prods: one
    value per lane; each row has its own CTAs and the same grouping, so a
    value may hold several rows): `ctas` CTAs of `threads` threads; thread t
    of the row's grid sums lanes t, t + T, ... (T threads in all); each warp
    of `warp` lanes folds by shuffle-downs (a lane past the warp's end reads
    its own value); lane 0 of warp 0 folds the warp sums (lanes past the
    warp count hold zero); each CTA's sum is a partial, and the row's last
    CTA's threads sum partials t, t + threads, ... and fold them the same
    way."""
    n = len(prods)
    nwarps = threads // warp

    def shfl_sum(vals, width):
        d = width // 2
        while d > 0:
            vals = [add(v, vals[i + d] if i % warp + d < warp else v) for i, v in enumerate(vals)]
            d //= 2
        return vals

    def cta_sum(acc):
        acc = shfl_sum(acc, warp)
        sm = [acc[w * warp] for w in range(nwarps)]
        w0 = shfl_sum([sm[lane] if lane < nwarps else zero for lane in range(warp)], nwarps)
        return w0[0]

    step = ctas * threads
    partials = []
    for c in range(ctas):
        acc = []
        for t in range(threads):
            s = zero
            for i in range(c * threads + t, n, step):
                s = add(s, prods[i])
            acc.append(s)
        partials.append(cta_sum(acc))
    acc = []
    for t in range(threads):
        s = zero
        for c in range(t, ctas, threads):
            s = add(s, partials[c])
        acc.append(s)
    return cta_sum(acc)


@pytest.mark.parametrize(
    "n, capacity",
    [(1, 8), (5, 8), (8, 8), (13, 8), (29, 4), (61, 2), (100, 26)],
    ids=["one-lane", "below-a-cta", "one-cta", "ragged", "waves", "one-cta-waves", "partials-past-threads"],
)
def test_dot_model_matches_tree_sum(n, capacity):
    """CTAs of 8 threads in warps of 4 (two warps), two rows on a card of
    `capacity` CTAs (``dot_grid``'s CTAs per row): n below one CTA, one
    CTA, ragged, several grid-stride waves deep, and more CTA partials than
    the last CTA has threads."""
    lf = field_kernels.limb_field(FR_PARAMS)
    f = tfr("cpu")
    rows = [f.encode(_values(n, 80 + n + r)) for r in range(2)]
    table = f.encode(_values(n, 90 + n))
    prods = lf.mont_mul(torch.stack(rows, dim=1), table.unsqueeze(1))  # (18, 2, n)
    zero = torch.zeros((18, 2), dtype=torch.int32)
    ctas = max(1, min(capacity // 2, -(-n // 8)))  # field_kernels.dot_grid at 8 threads a CTA
    got = dot_model([prods[..., i] for i in range(n)], lf.add, zero, threads=8, warp=4, ctas=ctas)
    assert torch.equal(got, field_kernels.plain_dot(FR_PARAMS, rows, table))


def test_kernel_constants_match_the_source():
    """The wrapper's CTA shape and per-launch maxima are the kernel's."""
    src = open(os.path.join(os.path.dirname(field_kernels.__file__), "..", "csrc", "field_kernels.cu")).read()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define("DOT_THREADS") == field_kernels.DOT_THREADS
    assert define("DOT_MAX_ROWS") == field_kernels.DOT_MAX_ROWS
    assert define("LINCOMB_MAX_TERMS") == field_kernels.LINCOMB_MAX_TERMS
