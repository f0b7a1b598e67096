"""The FFT's pass plan (K2b ``fft_pass``'s module, through its plain
version) against the JAX package's transforms and against the
stage-by-stage path the port ran before K2b (``chip_smoke.stage_path``,
whose K2 stages run their plain version on the CPU), limb for limb
(tolerance 0), on the CPU.

The JAX side runs only at n = 16 and n = 1024 and only programs that
tests/test_torch_fft.py already compiles; at n = 1024 the forward
transforms with a constant are held against the JAX transform of the input
scaled on the host (the JAX package multiplies by the constant first)."""

import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.polynomials import fft as jfft
from barretenberg_tpu.polynomials import get_domain as j_get_domain

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fr as tfr
from barretenberg_tpu_torch.fields.params import FR_PARAMS
from barretenberg_tpu_torch.kernels import butterfly
from barretenberg_tpu_torch.polynomials import fft, get_domain
from chip_smoke import FFT_VARIANTS as VARIANTS, stage_path

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

P = jfr.p
K = VARIANTS["fft_with_constant"][2]
# (tile_log, col_log): the default, and tiles of 2^2 and 2^3 elements that
# split n = 1024 into 5 and 4 passes (the last of 4 uneven)
TILES = {"default": (fft.TILE_LOG, fft.COL_LOG), "tile4": (2, 0), "tile8": (3, 0), "tile8x2": (3, 1)}


def _values(n, seed):
    """The edge values 0, 1 and p - 1, then seeded random ones."""
    rng = np.random.default_rng(seed)
    return [0, 1, P - 1] + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n - 3)]


def _same(t, j) -> bool:
    return np.array_equal(convert.field_array(t), np.asarray(j))


def _jax_transform(name, vals, n):
    jd = j_get_domain(n)
    if n > 16 and name in ("fft_with_constant", "coset_fft_with_constant"):
        base = "fft" if name == "fft_with_constant" else "coset_fft"
        return getattr(jfft, base)(jfr.encode([v * K % P for v in vals]), jd)
    args = (K,) if name.endswith("with_constant") else ()
    return getattr(jfft, name)(jfr.encode(vals), jd, *args)


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("n", [16, 1024])
def test_pass_plan_matches_jax(n, name, tile):
    vals = _values(n, 40 + n)
    want = _jax_transform(name, vals, n)
    k = n.bit_length() - 1
    plan = fft.fft_plan(k, *TILES[tile])
    x = tfr("cpu").encode(vals)
    inv, coset, val = VARIANTS[name]
    got = fft.transform(x, get_domain(n, "cpu"), inv, coset, val, plan)
    assert _same(got, want)
    if tile == "default":  # the public transform runs the default plan
        args = (K,) if val is not None else ()
        assert _same(getattr(fft, name)(x, get_domain(n, "cpu"), *args), want)


@pytest.mark.parametrize("tiles", [(5, 1), (7, 3), (9, 3)])
@pytest.mark.parametrize("name", ["fft", "coset_ifft", "coset_fft_with_constant"])
def test_pass_plan_equals_flat_stage_loop(name, tiles):
    n = 1 << 12
    d = get_domain(n, "cpu")
    x = tfr("cpu").encode(_values(n, 50))
    inv, coset, val = VARIANTS[name]
    plan = fft.fft_plan(12, *tiles)
    assert len(plan) > 1
    assert torch.equal(fft.transform(x, d, inv, coset, val, plan), stage_path(x, d, inv, coset, val))


def test_fft_plan_shapes():
    for k in range(0, 21):
        for tile_log, col_log in [(fft.TILE_LOG, fft.COL_LOG), (2, 0), (3, 0), (3, 1), (12, 4)]:
            plan = fft.fft_plan(k, tile_log, col_log)
            assert [s0 for s0, _, _ in plan] == [sum(b for _, b, _ in plan[:i]) for i in range(len(plan))]
            assert sum(b for _, b, _ in plan) == k
            for s0, b, cl in plan:
                assert b + cl <= tile_log  # the tile
                assert cl <= (k - b if s0 == 0 else s0)  # neighbouring groups exist
            if k <= tile_log:
                assert plan == [(0, k, 0)]
            else:
                assert max(b for _, b, _ in plan) <= tile_log - col_log
                assert max(b for _, b, _ in plan) - min(b for _, b, _ in plan) <= 1
    # the default plan: one pass for the golden n = 16, at most three to 2^18
    assert len(fft.fft_plan(4)) == 1
    assert all(len(fft.fft_plan(k)) <= 3 for k in range(19))
    assert len(fft.fft_plan(10, 2, 0)) == 5 and len(fft.fft_plan(10, 3, 0)) == 4
    with pytest.raises(ValueError):
        fft.fft_plan(10, 3, 3)


@pytest.mark.parametrize("s0,stages,col_log", [(0, 8, 5), (0, 11, 0), (2, 3, 3), (4, 8, 0)])
def test_fft_pass_kernel_wrapper_rejects_bad_plans(s0, stages, col_log):
    """The wrapper refuses a stage range or tile the kernel cannot run,
    before it builds or launches anything (n = 2^10)."""
    f = tfr("cpu")
    x = f.zeros((1024,))
    with pytest.raises(ValueError):
        butterfly._launch_pass(FR_PARAMS, x, f.zeros((512,)), 10, s0, stages, col_log, None, None, False)
