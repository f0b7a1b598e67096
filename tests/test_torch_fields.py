"""The port's field arithmetic (K1's module and `Field`) against the JAX
package, limb for limb.

Inputs are made with numpy from a seed, encoded once by the JAX package and
carried across with `convert.field_tensor`; the port runs on the CPU (the
kernel's plain version). The JAX side runs once through its XLA path and
once through its Pallas kernel in interpret mode. Tolerance 0: every value
is a canonical field element.
"""

import numpy as np
import pytest
import torch

from barretenberg_tpu import config as jconfig
from barretenberg_tpu.fields import fq as jfq, fr as jfr
from barretenberg_tpu.kernels import field_kernels as jkernels

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fq as tfq, fr as tfr
from barretenberg_tpu_torch.kernels import field_kernels as tkernels

N = 1024  # one full tile of the JAX kernel, as its own tests use
# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

FIELDS = {"fr": (jfr, tfr), "fq": (jfq, tfq)}


def _inputs(name, seed=5):
    jf, tf = FIELDS[name]
    rng = np.random.default_rng(seed)
    p = jf.p
    va = [0, 1, p - 1, p - 1] + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(N - 4)]
    vb = [0, 1, p - 1, 1] + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(N - 4)]
    ja, jb = jf.encode(va), jf.encode(vb)
    f = tf("cpu")
    return jf, f, (va, vb), (ja, jb), (convert.field_tensor(ja, "cpu"), convert.field_tensor(jb, "cpu"))


def _same(t: torch.Tensor, j) -> bool:
    return t.dtype == torch.int32 and np.array_equal(convert.field_array(t), np.asarray(j))


@pytest.fixture
def xla_path():
    jconfig.set_use_pallas(False)
    yield
    jconfig.set_use_pallas(None)


@pytest.fixture
def pallas_interpret():
    jconfig.set_use_pallas(True)
    jconfig.set_pallas_interpret(True)
    yield
    jconfig.set_use_pallas(None)
    jconfig.set_pallas_interpret(False)


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_op_matches_jax_xla(name, op, xla_path):
    jf, f, _, (ja, jb), (ta, tb) = _inputs(name)
    assert _same(getattr(f, op)(ta, tb), getattr(jf, op)(ja, jb))


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("op", ["mont_mul", "sqr", "add", "sub"])
def test_kernel_module_matches_jax_pallas_interpret(name, op, pallas_interpret):
    jf, f, _, (ja, jb), (ta, tb) = _inputs(name)
    if op == "sqr":
        got, want = tkernels.sqr(f.params, ta), jkernels.sqr(jf.params, ja)
    else:
        got = getattr(tkernels, op)(f.params, ta, tb)
        want = getattr(jkernels, op)(jf.params, ja, jb)
    assert _same(got, want)


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("op", ["sqr", "neg", "double", "to_plain", "to_montgomery_form", "from_montgomery_form"])
def test_unary_op_matches_jax_xla(name, op, xla_path):
    jf, f, _, (ja, _), (ta, _) = _inputs(name)
    assert _same(getattr(f, op)(ta), getattr(jf, op)(ja))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_broadcast_and_constant_products(name, xla_path):
    jf, f, (va, _), (ja, _), (ta, _) = _inputs(name)
    c = 0xC0FFEE
    assert _same(f.mul_by_constant(ta, c), jf.mul_by_constant(ja, c))
    col = f.encode([c])  # (18, 1) against (18, N)
    assert torch.equal(f.mont_mul(ta, col), f.mul_by_constant(ta, c))
    assert torch.equal(f.add(ta, col), f.add(ta, col.expand(18, N).contiguous()))
    # strided views need no copy on the card; on the CPU they must agree too
    assert torch.equal(f.mont_mul(ta[:, ::2], ta[:, 1::2]), f.mont_mul(ta[:, ::2].contiguous(), ta[:, 1::2].contiguous()))
    assert f.decode(f.mul_by_constant(ta[:, :8], c)) == [v * c % f.p for v in va[:8]]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_encode_decode_agree_with_jax(name):
    jf, f, (va, _), (ja, _), (ta, _) = _inputs(name)
    assert _same(f.encode(va), ja)
    assert f.decode(ta) == va
    raw = [v * (1 << 256) % f.p for v in va[:16]]
    assert _same(f.encode_montgomery(raw), jf.encode_montgomery(raw))
    assert f.decode_montgomery(f.encode_montgomery(raw)) == raw
    assert _same(f.const(12345), jf.const(12345))
    assert np.array_equal(convert.field_array(f.one), np.asarray(jf.one))
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    assert _same(f.random_elements(8, rng_t), jf.random_elements(8, rng_j))
    assert f.get_root_of_unity(10) == jf.get_root_of_unity(10)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_predicates_and_select(name):
    _, f, (va, vb), _, (ta, tb) = _inputs(name)
    assert f.is_zero(ta).tolist() == [v == 0 for v in va]
    assert f.eq(ta, tb).tolist() == [x == y for x, y in zip(va, vb)]
    mask = torch.arange(N) % 2 == 0
    sel = f.decode(f.select(mask, ta, tb))
    assert sel == [x if i % 2 == 0 else y for i, (x, y) in enumerate(zip(va, vb))]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_inversion(name):
    _, f, (va, _), _, (ta, _) = _inputs(name)
    p = f.p
    assert f.decode(f.invert(ta[:, :8])) == [0 if v == 0 else pow(v, -1, p) for v in va[:8]]
    assert f.decode(f.pow_static(ta[:, :8], 5)) == [pow(v, 5, p) for v in va[:8]]
    nz = ta[:, 1:65]
    assert f.decode(f.batch_invert(nz)) == [pow(v, -1, p) for v in va[1:65]]
    assert torch.equal(f.batch_invert(nz.reshape(18, 8, 8), dim=2).reshape(18, 64)[:, :8], f.batch_invert(nz[:, :8]))


def test_convert_rejects_non_canonical_limbs():
    bad = np.zeros((18, 4), dtype=np.uint32)
    bad[3, 1] = 1 << 15
    with pytest.raises(ValueError):
        convert.field_tensor(bad, "cpu")
    with pytest.raises(ValueError):
        convert.field_tensor(np.zeros((17, 4), dtype=np.uint32), "cpu")
