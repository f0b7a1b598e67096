"""The plain versions of the two chain kernels - K1 ``pow`` (a Fermat
inversion or any power with a host-known exponent) and K3c
``window_combine`` (Pippenger's Horner combine) - against the JAX package,
limb for limb (tolerance 0), on the CPU.

The JAX side runs under ``jax.disable_jit()``, op by op, so no XLA program
is compiled: its ``Field.pow_static`` / ``invert`` (a ``lax.scan`` of
``sqr`` / ``mont_mul`` steps, ~30 s for a 254-bit exponent here), and the
Horner ``fori_loop`` of its ``msm/pippenger.py`` (c doublings, then one add
of the round's window, most significant round first) composed from its
``g1.dbl`` / ``g1.add`` at c = 4 and 3 rounds, every edge case one lane of
one batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fq as jfq, fr as jfr
from barretenberg_tpu.groups import JacobianPoints as JJacobian
from barretenberg_tpu.groups.g1 import g1 as jg1

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fq as tfq, fr as tfr
from barretenberg_tpu_torch.fields.params import FQ_PARAMS, FR_MODULUS, FR_PARAMS
from barretenberg_tpu_torch.groups import JacobianPoints
from barretenberg_tpu_torch.groups.g1 import jacobian_to_host
from barretenberg_tpu_torch.kernels import field_kernels, msm_kernels
from barretenberg_tpu_torch.utils import host_curve

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

FQ_MODULUS = FQ_PARAMS.modulus
FIELDS = {"fr": (jfr, tfr, FR_PARAMS), "fq": (jfq, tfq, FQ_PARAMS)}
_RNG = np.random.default_rng(31)
EXPONENTS = {
    "p-2": FQ_MODULUS - 2,
    "r-2": FR_MODULUS - 2,
    "0": 0,
    "1": 1,
    "2": 2,
    "random254": int.from_bytes(_RNG.bytes(32), "little") >> 2 | 1 << 253,
}


def _lanes(p: int, seed: int) -> list:
    """The edge lanes 0, 1 and p - 1, then five random ones."""
    rng = np.random.default_rng(seed)
    return [0, 1, p - 1] + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(5)]


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(convert.field_array(t), np.asarray(j))


@pytest.mark.parametrize("exp_name", list(EXPONENTS))
@pytest.mark.parametrize("field_name", list(FIELDS))
def test_pow_matches_jax(field_name, exp_name):
    jf, tf, params = FIELDS[field_name]
    e = EXPONENTS[exp_name]
    f = tf("cpu")
    vals = _lanes(f.p, seed=len(exp_name))
    ja = jf.encode(vals)
    ta = convert.field_tensor(ja, "cpu")
    if e == 1:
        # a scan over zero bits cannot run under disable_jit(); the JAX
        # pow_static(a, 1) starts its accumulator at a and returns it
        want = np.asarray(ja)
    else:
        with jax.disable_jit():
            want = np.asarray(jf.pow_static(ja, e))
    got = field_kernels.plain_pow(params, ta, e)
    assert _same(got, want)
    assert _same(f.pow_static(ta, e), want)  # Field dispatches a CPU tensor to the plain version
    assert f.decode(got) == [pow(v, e, f.p) for v in vals]
    if e == f.p - 2:  # the field's own Fermat inversion
        assert _same(f.invert(ta), want)
        assert f.decode(got) == [0] + [pow(v, -1, f.p) for v in vals[1:]]
        # batch inversion (prefix/suffix products + one Fermat chain) of the nonzero lanes
        assert _same(f.batch_invert(ta[:, 1:]), want[:, 1:])


# ---------------------------------------------------------------------------
# the Horner combine
# ---------------------------------------------------------------------------
C, ROUNDS = 4, 3
CASES = ("all_infinity", "lowest_only", "doubling", "cancel")


def _horner_oracle(host_windows: list):
    acc = None
    for r, w in enumerate(host_windows):
        acc = host_curve.g1_add(acc, host_curve.g1_mul(w, 1 << (C * r)))
    return acc


def _edge_windows(case: str):
    """(18, ROUNDS) Jacobian windows (z != 1) for one edge case and the host
    points they stand for (None = infinity): every window at infinity; only
    the lowest live; window 1 equal to 2^C times window 2 (the add at round 1
    takes its doubling branch); window 1 its negation (the sum cancels to
    infinity before round 0). Windows at infinity keep live coordinates."""
    rng = np.random.default_rng(CASES.index(case) + 50)
    g = host_curve.G1_GENERATOR
    host = [host_curve.g1_mul(g, int(k)) for k in rng.integers(1, 1 << 30, size=ROUNDS)]
    coords = list(host)
    inf = [False] * ROUNDS
    if case == "all_infinity":
        inf = [True] * ROUNDS
    elif case == "lowest_only":
        inf = [False] + [True] * (ROUNDS - 1)
    else:
        target = host_curve.g1_mul(host[2], 1 << C)
        coords[1] = target if case == "doubling" else host_curve.g1_neg(target)
    q = FQ_MODULUS
    zs = [int.from_bytes(rng.bytes(32), "little") % (q - 1) + 1 for _ in range(ROUNDS)]
    f = tfq("cpu")
    x = f.encode([px * z * z % q for (px, _), z in zip(coords, zs)])
    y = f.encode([py * z * z * z % q for (_, py), z in zip(coords, zs)])
    windows = JacobianPoints(x, y, f.encode(zs), torch.tensor(inf))
    return windows, [None if i else p for i, p in zip(inf, coords)]


@pytest.fixture(scope="module")
def jax_horner():
    """The JAX package's Horner combine of every edge case at once, case i
    on lane i (its group law is lane-wise)."""
    wins = [_edge_windows(case)[0] for case in CASES]

    def lanes(coord, r):  # (18, cases): round r's window of every case
        return jnp.asarray(np.stack([convert.field_array(getattr(w, coord)[:, r]) for w in wins], axis=1))

    with jax.disable_jit():
        acc = jg1.infinity((len(CASES),))
        for r in reversed(range(ROUNDS)):
            for _ in range(C):
                acc = jg1.dbl(acc)
            win = JJacobian(lanes("x", r), lanes("y", r), lanes("z", r),
                            jnp.asarray(np.array([bool(w.inf[r]) for w in wins])))
            acc = jg1.add(acc, win)
    return [np.asarray(t) for t in acc]


def test_window_combine_matches_jax_horner(jax_horner):
    jx, jy, jz, jinf = jax_horner
    for i, case in enumerate(CASES):
        got = msm_kernels.plain_window_combine(_edge_windows(case)[0], C)
        assert _same(got.x[:, 0], jx[:, i]) and _same(got.y[:, 0], jy[:, i]) and _same(got.z[:, 0], jz[:, i]), case
        assert bool(got.inf[0]) == bool(jinf[i]), case


@pytest.mark.parametrize("case", CASES)
def test_window_combine_matches_host_oracle(case):
    windows, host = _edge_windows(case)
    got = msm_kernels.plain_window_combine(windows, C)
    assert got.x.shape == (18, 1) and got.inf.shape == (1,)
    assert jacobian_to_host(got) == [_horner_oracle(host)]
    assert bool(got.inf[0]) == (case == "all_infinity")  # after "cancel", window 0 is added to infinity
    # a CPU batch takes the plain version
    assert all(torch.equal(a, b) for a, b in zip(msm_kernels.window_combine(windows, C), got))
