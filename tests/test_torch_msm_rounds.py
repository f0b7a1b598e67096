"""The rounds-batched Pippenger schedule of B scalar vectors over one point
set (``msm/pippenger.py::pippenger_batch``: one K4, one sort, one K3a, one
K3b-wide and one K3c call for all B) against B single ``pippenger`` calls,
the JAX package's non-fused ``pippenger`` (Jacobian coordinates limb for
limb) and the host oracle, on the CPU with the kernels' plain versions;
K3b-wide over the rounds as bucket sets against K3b; K3c over B lanes
against B single chains; the prover's commitments on the batched route
against the table route; and the port's host encoding against the JAX
package's.

The JAX side runs once per module at the shape tests/test_msm.py compiles
(N = 64, c = 8, block 16). At c = 13, the window of the 2^20 prove, the
port's plain suffix scans over 4,096 buckets and a cold XLA compile take
minutes: that test is marked slow."""

import json
import pathlib

import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fq as jfq, fr as jfr
from barretenberg_tpu.fields.limbs import ints_to_limbs as j_ints_to_limbs
from barretenberg_tpu.groups.g1 import host_to_affine_points as j_host_to_affine
from barretenberg_tpu.msm import pippenger as j_pippenger

from barretenberg_tpu_torch import convert, fixtures
from barretenberg_tpu_torch.fields import fq as tfq, fr as tfr
from barretenberg_tpu_torch.fields.limbs import ints_to_limbs
from barretenberg_tpu_torch.fields.params import FR_MODULUS
from barretenberg_tpu_torch.groups import AffinePoints, JacobianPoints
from barretenberg_tpu_torch.groups.g1 import fixed_base_mul, jacobian_to_host, points_to_host
from barretenberg_tpu_torch.kernels import msm_kernels
from barretenberg_tpu_torch.msm import naive, pippenger, pippenger_batch
from barretenberg_tpu_torch.msm.pippenger import glv_entries
from barretenberg_tpu_torch.plonk.prover import Prover
from barretenberg_tpu_torch.srs import test_srs
from barretenberg_tpu_torch.utils import host_curve

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

N, C, BLOCK = 64, 8, 16  # the configuration tests/test_msm.py compiles
P = FR_MODULUS
STAGES = ("glv_digits", "sort_rounds", "bucket_accumulate", "bucket_reduce", "bucket_reduce_wide", "window_combine")


def _same(t, j) -> bool:
    return all(np.array_equal(tc.numpy().astype(np.asarray(jc).dtype), np.asarray(jc)) for tc, jc in zip(t, j))


def _lane(p: JacobianPoints, b: int) -> JacobianPoints:
    return JacobianPoints(*(t[..., b : b + 1] for t in p))


def _edge_inputs(n: int, seed: int):
    """n host points (lane 5 at infinity, lane 7 repeating lane 6) and three
    scalar vectors: random with 0, 1, r - 1 in front; all zero; one scalar
    repeated (one bucket of a round spans every block)."""
    rng = np.random.default_rng(seed)
    g = host_curve.G1_GENERATOR
    host_pts = [host_curve.g1_mul(g, int(k)) for k in rng.integers(1, 1 << 30, size=n)]
    host_pts[5] = None
    host_pts[7] = host_pts[6]
    vecs = [[0, 1, P - 1] + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n - 3)],
            [0] * n, [int.from_bytes(rng.bytes(32), "little") % P] * n]
    return host_pts, vecs


def _batched(vecs, tpts, c: int, block: int, monkeypatch):
    """pippenger_batch of the vectors, with the calls it made of each stage
    (the kernel wrappers of msm_kernels) and the sets each took."""
    calls = {s: [] for s in STAGES}
    for stage in STAGES:
        def rec(*args, _stage=stage, _fn=getattr(msm_kernels, stage), **kw):
            calls[_stage].append(args[1:] if _stage in ("glv_digits", "window_combine") else ())
            return _fn(*args, **kw)
        monkeypatch.setattr(msm_kernels, stage, rec)
    fr = tfr("cpu")
    res = pippenger_batch([fr.encode(v) for v in vecs], tpts, c=c, block=block)
    monkeypatch.undo()
    return res, calls


@pytest.fixture(scope="module")
def c8():
    host_pts, vecs = _edge_inputs(N, 61)
    jpts = j_host_to_affine(host_pts)
    tpts = convert.affine_points(*(np.asarray(t) for t in jpts), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        res, calls = _batched(vecs, tpts, C, BLOCK, mp)
    return host_pts, vecs, jpts, tpts, res, calls


@pytest.fixture(scope="module")
def jax_c8(c8):
    """The JAX package's non-fused Pippenger of the first vector."""
    _, vecs, jpts, *_ = c8
    return j_pippenger(jfr.encode(vecs[0]), jpts, c=C, block=BLOCK, fused=False)


def test_batched_schedule_is_one_launch_set(c8):
    """Three MSMs: one K4 over three sets, one sort, one K3a, one K3b-wide
    over the 3 x 17 rounds, one K3c over three chains, and no K3b."""
    calls = c8[-1]
    assert {s: len(v) for s, v in calls.items()} == {
        "glv_digits": 1, "sort_rounds": 1, "bucket_accumulate": 1, "bucket_reduce": 0,
        "bucket_reduce_wide": 1, "window_combine": 1}
    sets, c, m = calls["glv_digits"][0]
    assert (sets, c, m) == (3, C, msm_kernels.digit_rounds(C) * 2 * N)
    assert calls["window_combine"][0] == (C, 3)


def test_batched_matches_jax_non_fused_and_host(c8, jax_c8):
    host_pts, vecs, _, _, res, _ = c8
    assert _same(_lane(res, 0), jax_c8)
    assert jacobian_to_host(res) == [host_curve.g1_msm(host_pts, v) for v in vecs]


@pytest.mark.parametrize("b", [0, 1, 2])
def test_batched_matches_single_calls(c8, b):
    """Each MSM of the batch equals its own pippenger call (B = 1), limb for
    limb: the random vector, the all-zero one (infinity), the equal one."""
    _, vecs, _, tpts, res, _ = c8
    single = pippenger(tfr("cpu").encode(vecs[b]), tpts, c=C, block=BLOCK)
    assert all(torch.equal(g, w) for g, w in zip(_lane(res, b), single))
    assert single.inf.shape == (1,)


def test_batched_pads_each_round_to_the_block(monkeypatch):
    """2N = 72 entries a round padded to 80 (block 16), c = 4: the batch of
    the three edge vectors equals the single calls and the host oracle."""
    n, c, block = 36, 4, 16
    host_pts, vecs = _edge_inputs(n, 62)
    tpts = convert.affine_points(*(np.asarray(t) for t in j_host_to_affine(host_pts)), device="cpu")
    digits, px, _, pinf = glv_entries(tfr("cpu").encode(sum(vecs, [])), tpts, c, block, sets=3)
    rounds = msm_kernels.digit_rounds(c)
    assert tuple(digits.shape) == (3 * rounds, 80) and tuple(px.shape) == (18, 80)
    assert not digits[:, 2 * n :].any() and bool(pinf[2 * n :].all())
    res, calls = _batched(vecs, tpts, c, block, monkeypatch)
    assert len(calls["bucket_reduce_wide"]) == 1 and len(calls["window_combine"]) == 1
    fr = tfr("cpu")
    for b, v in enumerate(vecs):
        single = pippenger(fr.encode(v), tpts, c=c, block=block)
        assert all(torch.equal(g, w) for g, w in zip(_lane(res, b), single))
    assert jacobian_to_host(res) == [host_curve.g1_msm(host_pts, v) for v in vecs]


@pytest.mark.parametrize("range_buckets", [128, 16, 7])
def test_wide_reduce_over_rounds_equals_k3b(c8, range_buckets):
    """K3b-wide's plain version over the first MSM's 17 rounds as bucket
    sets, each set cut into ranges of `range_buckets` buckets as the
    kernel's clusters cut it (128: one cluster a round, as at 3 x 11 sets
    on the card), equals K3b's plain version window for window; and a set's
    window does not depend on the sets beside it."""
    _, vecs, _, tpts, _, _ = c8
    nb = 1 << (C - 1)
    digits, px, py, pinf = glv_entries(tfr("cpu").encode(vecs[0]), tpts, C, BLOCK)
    partials = msm_kernels.bucket_accumulate(msm_kernels.sort_rounds(digits, nb), px, py, pinf, nb, BLOCK)
    want = msm_kernels.plain_bucket_reduce(partials, nb)
    got = msm_kernels.plain_bucket_reduce_wide(partials, nb, range_buckets)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the batch's first 17 windows are these: K3c of the batch's first lane
    # over them gives the batch's first MSM
    assert all(torch.equal(g, w) for g, w in zip(msm_kernels.plain_window_combine(got, C), _lane(c8[4], 0)))


def _horner(host_windows: list, c: int):
    acc = None
    for r, w in enumerate(host_windows):
        acc = host_curve.g1_add(acc, host_curve.g1_mul(w, 1 << (c * r)))
    return acc


def test_window_combine_lanes_equal_single_chains():
    """K3c's plain version over B = 3 chains of the 2^20 prove's shape (c =
    13, 11 rounds) equals three single chains and the host oracle: set 0
    random windows (z != 1), set 1 every window at infinity, set 2 only its
    lowest window live; the wrapper takes the plain version on the CPU."""
    c, rounds, sets = 13, msm_kernels.digit_rounds(13), 3
    rng = np.random.default_rng(63)
    win = fixed_base_mul([int(k) for k in rng.integers(1, 1 << 62, size=sets * rounds)], "cpu")
    win.inf[rounds : 2 * rounds] = True
    win.inf[2 * rounds + 1 :] = True
    host = jacobian_to_host(win)
    got = msm_kernels.plain_window_combine(win, c, sets)
    assert got.inf.shape == (sets,)
    for s in range(sets):
        lanes = slice(s * rounds, (s + 1) * rounds)
        single = msm_kernels.plain_window_combine(JacobianPoints(*(t[..., lanes] for t in win)), c)
        assert all(torch.equal(g, w) for g, w in zip(_lane(got, s), single))
    assert jacobian_to_host(got) == [_horner(host[s * rounds : (s + 1) * rounds], c) for s in range(sets)]
    assert all(torch.equal(g, w) for g, w in zip(msm_kernels.window_combine(win, c, sets), got))
    with pytest.raises(ValueError):
        msm_kernels.window_combine(win, c, 2)


def test_batched_msm_takes_one_batched_schedule(monkeypatch):
    """From MSM_PIPPENGER_THRESHOLD points batched_msm hands all B vectors
    to one pippenger_batch call; below it, one double-and-add."""
    seen = []
    monkeypatch.setattr(naive, "pippenger_batch", lambda scalars, points: seen.append(len(scalars)) or "batch")
    n = naive.MSM_PIPPENGER_THRESHOLD
    zero = torch.zeros((18, n), dtype=torch.int32)
    pts = AffinePoints(zero, zero, torch.ones(n, dtype=torch.bool))
    scalars = [torch.zeros((18, n), dtype=torch.int32)] * 3
    assert naive.batched_msm(scalars, pts) == "batch" and seen == [3]


def _commit_both_routes(n: int, seed: int):
    """One commitment of a prover at n gates through the SRS's table and of
    one forced off it (its _PRECOMP_MAX_N lowered on the instance), which
    commits through batched_msm, the JAX prover's route above 2^18; and
    the host oracle's."""
    srs = test_srs(n, device="cpu")
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    vals[:3] = [0, 1, P - 1]
    coeffs = [tfr("cpu").encode(vals)]
    table = Prover(n, srs, device="cpu")
    rounds = Prover(n, srs, device="cpu")
    rounds._PRECOMP_MAX_N = n // 2
    assert rounds._precomputed_table() is None and table._precomputed_table() is not None
    want = [host_curve.g1_msm(points_to_host(rounds.monomials), vals)]
    return rounds.commit_batch(coeffs), table.commit_batch(coeffs), want


def test_commit_batch_on_the_rounds_route_matches_the_table_route(monkeypatch):
    """At n = 1024, with batched_msm's Pippenger threshold lowered to n, the
    rounds route gives the table route's affine point and the host
    oracle's."""
    n = 1 << 10
    monkeypatch.setattr(naive, "MSM_PIPPENGER_THRESHOLD", n)
    rounds, table, want = _commit_both_routes(n, 64)
    assert rounds == table == want


@pytest.mark.slow
def test_commit_batch_on_the_rounds_route_at_4096():
    """The same at n = 4096, the rounds route's own threshold (~3-5 min)."""
    rounds, table, want = _commit_both_routes(1 << 12, 68)
    assert rounds == table == want


@pytest.mark.parametrize("field, jfield", [(tfr, jfr), (tfq, jfq)], ids=["fr", "fq"])
def test_encode_matches_jax_on_edge_values(field, jfield):
    """The port's encode (one Python product a value, limbs cut by numpy)
    equals the JAX package's Field.encode on 0, 1, p - 1, values >= p
    (reduced mod p), negative values and random ones."""
    p = jfield.p
    rng = np.random.default_rng(65)
    vals = [0, 1, p - 1, p, p + 1, 2 * p + 3, (1 << 254) - 1, (1 << 256) - 1, (1 << 300) + 7, -1, -p - 2]
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(200)]
    got = field("cpu").encode(vals)
    assert np.array_equal(got.numpy(), np.asarray(jfield.encode(vals)).astype(np.int32))
    assert field("cpu").decode(got) == [v % p for v in vals]


def test_ints_to_limbs_matches_jax():
    """The word-shift limb split equals the JAX package's bit-unpacking one
    up to 2^270 - 1, and both refuse 2^270 and negative values."""
    rng = np.random.default_rng(66)
    vals = [0, 1, (1 << 15) - 1, 1 << 15, (1 << 64) - 1, 1 << 64, (1 << 255) + 3, (1 << 270) - 1]
    vals += [int.from_bytes(rng.bytes(34), "little") >> 2 for _ in range(300)]
    assert np.array_equal(ints_to_limbs(vals), j_ints_to_limbs(vals))
    assert ints_to_limbs([]).shape == (18, 0)
    for bad in ([1 << 270], [5, -1]):
        with pytest.raises(ValueError):
            ints_to_limbs(bad)


def _splitmix_reference(state: int):
    mask = (1 << 64) - 1
    while True:
        state = (state + 0x9E3779B97F4A7C15) & mask
        z = ((state ^ (state >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        yield z ^ (z >> 31)


def test_crosscheck_2e20_digest_is_the_record():
    """The digest the card's 2^20 proof is held to is CROSSCHECK.json's
    arithmetic_2e20 case (the reference C++ prover's bytes)."""
    cases = json.loads((pathlib.Path(__file__).resolve().parent.parent / "CROSSCHECK.json").read_text())["cases"]
    (case,) = [c for c in cases if c["name"] == "arithmetic_2e20"]
    assert (case["n"], case["with_bool"], case["identical"]) == (1 << 20, False, True)
    assert case["proof_sha256"] == fixtures.CROSSCHECK_2E20_SHA256


def test_crosscheck_fixture_values_are_the_splitmix_stream():
    """The fixture's values, computed all at once with numpy, are splitmix64's
    stream from the fixture seed four words each, the top word cut to 61
    bits, as the reference C++ fixture draws them."""
    gen = _splitmix_reference(fixtures.SEED)
    words = [next(gen) for _ in range(4 * 500)]
    assert fixtures._splitmix_words(4 * 500).tolist() == words
    want = [w[0] | w[1] << 64 | w[2] << 128 | (w[3] & ((1 << 61) - 1)) << 192
            for w in zip(*(words[j::4] for j in range(4)))]
    assert fixtures._det_values(500) == want


@pytest.mark.slow
def test_batched_matches_jax_at_the_2e20_window():
    """c = 13 (11 rounds, 4,096 buckets), B = 3: the batch equals the JAX
    package's non-fused Pippenger of the first vector, the single calls and
    the host oracle."""
    host_pts, vecs = _edge_inputs(N, 67)
    jpts = j_host_to_affine(host_pts)
    tpts = convert.affine_points(*(np.asarray(t) for t in jpts), device="cpu")
    fr = tfr("cpu")
    res = pippenger_batch([fr.encode(v) for v in vecs], tpts, c=13, block=BLOCK)
    assert _same(_lane(res, 0), j_pippenger(jfr.encode(vecs[0]), jpts, c=13, block=BLOCK, fused=False))
    for b, v in enumerate(vecs):
        single = pippenger(fr.encode(v), tpts, c=13, block=BLOCK)
        assert all(torch.equal(g, w) for g, w in zip(_lane(res, b), single))
    assert jacobian_to_host(res) == [host_curve.g1_msm(host_pts, v) for v in vecs]
