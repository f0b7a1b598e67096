"""The port's butterfly stage (K2's module), FFTs and polynomial arithmetic
against the JAX package, limb for limb (tolerance 0), on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.fields.params import FR_PARAMS as JFR_PARAMS
from barretenberg_tpu.kernels.butterfly import butterfly_stage as j_butterfly_stage
from barretenberg_tpu.polynomials import arithmetic as jarith
from barretenberg_tpu.polynomials import fft as jfft
from barretenberg_tpu.polynomials import get_domain as j_get_domain

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fr as tfr
from barretenberg_tpu_torch.fields.params import FR_PARAMS
from barretenberg_tpu_torch.kernels import butterfly
from barretenberg_tpu_torch.polynomials import arithmetic, fft, get_domain
from barretenberg_tpu_torch.utils.scans import affine_scan, hillis_scan

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

P = jfr.p


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _same(t, j) -> bool:
    return np.array_equal(convert.field_array(t), np.asarray(j))


def test_butterfly_stage_matches_jax_kernel_in_interpret_mode():
    g, h, nb = 1, 1, 8  # a small view: the interpreted kernel compiles in well under a minute
    jx = jfr.encode([0, 1, P - 1] + _values(g * 2 * h * nb - 3, 11))
    jtw = jfr.encode(_values(h, 12))
    jx5 = jx.reshape(18, g, 2, h, nb)
    want = j_butterfly_stage(JFR_PARAMS, jx5, jtw, interpret=True)
    x5 = convert.field_tensor(jx5, "cpu")
    got = butterfly.butterfly_stage(FR_PARAMS, x5, convert.field_tensor(jtw, "cpu"))
    assert got.shape == x5.shape and _same(got, want)


def test_butterfly_stage_matches_jax_field_ops_on_a_wide_view():
    """The same stage through the JAX package's XLA field ops (the kernel's
    own reference there), at a view of the kernel's usual tile widths."""
    g, h, nb = 2, 4, 128
    jx5 = jfr.encode(_values(g * 2 * h * nb, 15)).reshape(18, g, 2, h, nb)
    jtw = jfr.encode(_values(h, 16))
    je, jo = jx5[:, :, 0].reshape(18, -1), jx5[:, :, 1].reshape(18, -1)
    jt = jfr.mont_mul(jo, jnp.broadcast_to(jtw[:, None, :, None], (18, g, h, nb)).reshape(18, -1))
    got = butterfly.butterfly_stage(
        FR_PARAMS, convert.field_tensor(jx5, "cpu"), convert.field_tensor(jtw, "cpu")
    )
    assert _same(got[:, :, 0].reshape(18, -1), jfr.add(je, jt))
    assert _same(got[:, :, 1].reshape(18, -1), jfr.sub(je, jt))


@pytest.mark.parametrize("g,h,nb", [(4, 1, 1), (1, 8, 1), (2, 2, 3)])
def test_butterfly_stage_flat_views_match_field_ops(g, h, nb):
    f = tfr("cpu")
    x5 = f.encode(_values(g * 2 * h * nb, 13)).reshape(18, g, 2, h, nb)
    tw = f.encode(_values(2 * h, 14))[:, ::2]  # a strided twiddle slice
    got = butterfly.butterfly_stage(FR_PARAMS, x5, tw)
    e, o = x5[:, :, 0], x5[:, :, 1]
    t = f.mont_mul(o, tw.reshape(18, 1, h, 1))
    assert torch.equal(got[:, :, 0], f.add(e, t)) and torch.equal(got[:, :, 1], f.sub(e, t))


@pytest.mark.parametrize("n", [16, 1024])
@pytest.mark.parametrize("transform", ["fft", "ifft", "coset_fft", "coset_ifft"])
def test_transform_matches_jax(n, transform):
    jc = jfr.encode(_values(n, 20 + n))
    want = getattr(jfft, transform)(jc, j_get_domain(n))
    got = getattr(fft, transform)(convert.field_tensor(jc, "cpu"), get_domain(n, "cpu"))
    assert _same(got, want)


def test_transforms_with_constant_match_jax():
    n, k = 16, 0xBEEF
    jc = jfr.encode(_values(n, 31))
    tc, jd, td = convert.field_tensor(jc, "cpu"), j_get_domain(n), get_domain(n, "cpu")
    assert _same(fft.fft_with_constant(tc, td, k), jfft.fft_with_constant(jc, jd, k))
    assert _same(fft.ifft_with_constant(tc, td, k), jfft.ifft_with_constant(jc, jd, k))
    assert _same(fft.coset_fft_with_constant(tc, td, k), jfft.coset_fft_with_constant(jc, jd, k))


def test_fft_matches_dft_oracle_and_round_trips():
    n = 8
    f, d = tfr("cpu"), get_domain(8, "cpu")
    cv = _values(n, 32)
    c = f.encode(cv)
    want = [sum(cv[i] * pow(d.root, i * k, P) for i in range(n)) % P for k in range(n)]
    assert f.decode(fft.fft(c, d)) == want
    assert torch.equal(fft.ifft(fft.fft(c, d), d), c)
    assert torch.equal(fft.coset_ifft(fft.coset_fft(c, d), d), c)


def test_domain_tables_match_jax():
    n = 16
    jd, td = j_get_domain(n), get_domain(n, "cpu")
    assert (td.root, td.root_inverse, td.domain_inverse) == (jd.root, jd.root_inverse, jd.domain_inverse)
    assert _same(td.twiddles, jd.twiddles)
    assert _same(td.inverse_twiddles, jd.inverse_twiddles)
    assert _same(td.coset_scale, jd.coset_scale)
    assert _same(td.root_vector(), jd.root_vector())
    assert _same(td.coset_root_vector(), jd.coset_root_vector())
    assert td.bit_reverse_indices.tolist() == np.asarray(jd.bit_reverse_indices).tolist()
    assert get_domain(n, "cpu") is td


def test_polynomial_arithmetic_matches_jax():
    n = 16
    jc = jfr.encode(_values(n, 33))
    tc = convert.field_tensor(jc, "cpu")
    z = _values(1, 34)[0]
    assert arithmetic.evaluate(tc, z) == jarith.evaluate(jc, z)
    js, jm, jl = j_get_domain(n), j_get_domain(2 * n), j_get_domain(4 * n)
    ts, tm, tl = get_domain(n, "cpu"), get_domain(2 * n, "cpu"), get_domain(4 * n, "cpu")
    assert _same(
        arithmetic.compute_lagrange_polynomial_fft(ts, tm),
        jarith.compute_lagrange_polynomial_fft(js, jm),
    )
    je = jfr.encode(_values(4 * n, 35))
    assert _same(
        arithmetic.divide_by_pseudo_vanishing_polynomial(convert.field_tensor(je, "cpu"), ts, tl),
        jarith.divide_by_pseudo_vanishing_polynomial(je, js, jl),
    )
    assert tuple(arithmetic.get_lagrange_evaluations(z, ts)) == tuple(jarith.get_lagrange_evaluations(z, js))


def test_scans_against_sequential_loops():
    f = tfr("cpu")
    n = 13  # not a power of two
    av, bv = _values(n, 36), _values(n, 37)
    a, b = f.encode(av), f.encode(bv)
    pre, acc = [], 1
    for v in av:
        acc = acc * v % P
        pre.append(acc)
    assert f.decode(hillis_scan(f.mul, a, dim=1)) == pre
    suf, acc = [], 1
    for v in reversed(av):
        acc = acc * v % P
        suf.append(acc)
    assert f.decode(hillis_scan(f.mul, a, dim=1, reverse=True)) == suf[::-1]
    d, out = 0, []
    for i, (m, c) in enumerate(zip(av, bv)):
        d = c if i == 0 else (m * d + c) % P
        out.append(d)
    assert f.decode(affine_scan(f.mul, f.add, a, b, dim=1)) == out
