"""The fused Pippenger schedule (``msm/pippenger.py::_pippenger_fused_impl``:
every round's entries in one bucket set of R x 2^(c-1) buckets, one K4 /
sort / K3a / K3b-wide / K3c launch set per call) against the JAX package's
``pippenger(fused=True)``, Jacobian limb for limb (tolerance 0), and the
host oracle, on the CPU where the kernel wrappers take their plain
versions. The JAX side runs at tests/test_msm.py's N, C, BLOCK = 64, 8, 16
(the program its suite compiles), with its points and edge scalars. Also
the dispatch rule (``msm`` / ``batched_msm`` / ``pippenger`` pick the fused
schedule for 4096 <= n <= 2^15), K4's round-folded digits against the JAX
package's fused bucket index, K3b-wide's fused reduce cut into
round-bounded ranges, and a Python model of the kernel's per-range
segmented suffix scans."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.groups import AffinePoints as JAffine
from barretenberg_tpu.msm import pippenger as j_pippenger
from barretenberg_tpu.msm.wnaf import signed_digits as j_signed_digits
from barretenberg_tpu.msm.wnaf import split_scalars as j_split_scalars

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fr as tfr
from barretenberg_tpu_torch.groups import JacobianPoints
from barretenberg_tpu_torch.groups.g1 import jacobian_to_host, points_to_host, random_affine_points
from barretenberg_tpu_torch.kernels import msm_kernels, point_kernels
from barretenberg_tpu_torch.msm import FUSED_MAX_N, batched_msm, msm, naive, pippenger, pippenger_batch
from barretenberg_tpu_torch.utils import host_curve

torch.set_num_threads(1)
tpip = importlib.import_module("barretenberg_tpu_torch.msm.pippenger")  # the module (msm exports its function)

N, C, BLOCK = 64, 8, 16
R = jfr.p
STAGES = ("glv_digits", "sort_rounds", "bucket_accumulate", "bucket_reduce", "bucket_reduce_wide", "window_combine")


def _same(t, j) -> bool:
    return all(np.array_equal(tc.cpu().numpy().astype(np.asarray(jc).dtype), np.asarray(jc)) for tc, jc in zip(t, j))


def _lane(p: JacobianPoints, i: int) -> JacobianPoints:
    return JacobianPoints(p.x[:, i : i + 1], p.y[:, i : i + 1], p.z[:, i : i + 1], p.inf[i : i + 1])


@pytest.fixture(scope="module")
def data():
    """tests/test_msm.py's 64 points (seed 21; the port's random_affine_points
    gives the JAX package's, tests/test_torch_g1_surface.py holds this) and
    its scalar vectors: random
    (seed 31) and the edge scalars (seed 32: 0, 1, r - 1, 2, 3, 0, r - 1, 1
    in front), and a third vector with every scalar equal (one bucket of
    each round spans every block)."""
    tpts = random_affine_points(N, np.random.default_rng(21), device="cpu")  # the JAX package's points
    jpts = JAffine(*(jnp.asarray(convert.field_array(t)) for t in tpts[:2]), jnp.asarray(tpts.inf.numpy()))
    rng = np.random.default_rng(31)
    rand = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(N)]
    rng = np.random.default_rng(32)
    edge = [0, 1, R - 1, 2, 3, 0, R - 1, 1] + [int.from_bytes(rng.bytes(32), "little") % R for _ in range(N - 8)]
    vecs = [rand, edge, [rand[0]] * N]
    return jpts, tpts, vecs


def _recorded(monkeypatch, fn):
    """fn() with the calls it made of each msm_kernels stage and their
    keyword arguments."""
    calls = {s: [] for s in STAGES}
    for stage in STAGES:
        def rec(*args, _stage=stage, _fn=getattr(msm_kernels, stage), **kw):
            calls[_stage].append(kw)
            return _fn(*args, **kw)
        monkeypatch.setattr(msm_kernels, stage, rec)
    out = fn()
    monkeypatch.undo()
    return out, calls


@pytest.fixture(scope="module")
def fused3(data):
    """The three vectors as one fused launch set, with its stage calls."""
    _, tpts, vecs = data
    with pytest.MonkeyPatch.context() as mp:
        return _recorded(mp, lambda: pippenger_batch([tfr("cpu").encode(v) for v in vecs], tpts, C, BLOCK, fused=True))


@pytest.mark.parametrize("vec", [0, 1], ids=["random", "edge"])
def test_fused_matches_jax_and_host(data, fused3, vec):
    jpts, tpts, vecs = data
    want = j_pippenger(jfr.encode(vecs[vec]), jpts, c=C, block=BLOCK, fused=True)
    got = pippenger(tfr("cpu").encode(vecs[vec]), tpts, c=C, block=BLOCK, fused=True)
    assert _same(got, want)
    assert _same(_lane(fused3[0], vec), want)  # the same coordinates from the 3-vector launch set
    assert jacobian_to_host(got) == [host_curve.g1_msm(points_to_host(tpts), vecs[vec])]


def test_fused_batch_is_one_launch_set_of_per_vector_results(data, fused3):
    """Three vectors: one K4 (round offset 2^(c-1)), one sort, one K3a, one
    K3b-wide (per-round segments), one K3c, no K3b; each lane the single
    vector's fused result and the host oracle's."""
    _, tpts, vecs = data
    res, calls = fused3
    assert {s: len(v) for s, v in calls.items()} == {
        "glv_digits": 1, "sort_rounds": 1, "bucket_accumulate": 1, "bucket_reduce": 0,
        "bucket_reduce_wide": 1, "window_combine": 1}
    assert calls["glv_digits"][0] == {"round_offset": 1 << (C - 1)}
    assert calls["bucket_reduce_wide"][0] == {"segment": 1 << (C - 1)}
    single = pippenger(tfr("cpu").encode(vecs[2]), tpts, c=C, block=BLOCK, fused=True)
    assert _same(_lane(res, 2), [t.numpy() for t in single])
    host = points_to_host(tpts)
    assert jacobian_to_host(res) == [host_curve.g1_msm(host, v) for v in vecs]


def test_fused_and_rounds_schedules_agree_in_affine_form(data):
    _, tpts, vecs = data
    s = tfr("cpu").encode(vecs[1])
    fused = jacobian_to_host(pippenger(s, tpts, c=4, block=BLOCK, fused=True))
    rounds = jacobian_to_host(pippenger(s, tpts, c=4, block=BLOCK, fused=False))
    assert fused == rounds == [host_curve.g1_msm(points_to_host(tpts), vecs[1])]


def test_fused_all_zero_scalars_is_infinity(data):
    _, tpts, _ = data
    res = pippenger(tfr("cpu").encode([0] * N), tpts, c=C, block=BLOCK, fused=True)
    assert bool(res.inf.all())


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
@pytest.fixture
def schedules(monkeypatch):
    """pippenger_batch's two schedules replaced by recorders of (schedule,
    n, c, block, sets)."""
    seen = []
    for name in ("_pippenger_fused_impl", "_pippenger_impl"):
        def rec(scalars, points, c, block, sets=1, _name=name):
            seen.append((_name, points.x.shape[1], c, block, sets))
            return _name
        monkeypatch.setattr(tpip, name, rec)
    return seen


def _zeros(n: int, b: int = 1):
    pts = tpip.AffinePoints(torch.zeros((18, n), dtype=torch.int32), torch.zeros((18, n), dtype=torch.int32),
                            torch.ones(n, dtype=torch.bool))
    return [torch.zeros((18, n), dtype=torch.int32)] * b, pts


@pytest.mark.parametrize("n, fused", [(4095, False), (4096, True), (FUSED_MAX_N, True), (FUSED_MAX_N + 1, False)])
def test_pippenger_picks_the_fused_schedule_where_jax_does(schedules, n, fused):
    """From 4096 points (where msm / batched_msm leave the naive MSM) to
    FUSED_MAX_N = 2^15 (the JAX package's cutover) the default is fused,
    with the JAX package's block min(128, max(16, 2n)); fused= forces it."""
    scalars, pts = _zeros(n)
    want = "_pippenger_fused_impl" if fused else "_pippenger_impl"
    assert FUSED_MAX_N == 1 << 15
    assert pippenger(scalars[0], pts) == want
    assert schedules[-1] == (want, n, tpip.optimal_window(n), 128, 1)
    assert pippenger(scalars[0], pts, fused=not fused) != want


def test_msm_and_batched_msm_dispatch(schedules):
    """msm and batched_msm at 4096 and 2^15 points take the fused schedule,
    B vectors as B sets of one call; above 2^15 the rounds-batched one; the
    low-memory MSM's chunks always the rounds-batched one."""
    for n in (4096, FUSED_MAX_N, FUSED_MAX_N + 8):
        scalars, pts = _zeros(n, 3)
        kind = "_pippenger_fused_impl" if n <= FUSED_MAX_N else "_pippenger_impl"
        assert msm(scalars[0], pts) == kind and schedules[-1][4] == 1
        assert batched_msm(scalars, pts) == kind and schedules[-1][4] == 3
    scalars, pts = _zeros(8)
    before = len(schedules)
    small = msm(scalars[0], pts)  # below the threshold: the naive MSM
    assert len(schedules) == before and bool(small.inf.all())
    assert naive.MSM_PIPPENGER_THRESHOLD == tpip.MSM_PIPPENGER_THRESHOLD == 4096


def test_low_memory_chunks_take_the_rounds_schedule(schedules, monkeypatch):
    monkeypatch.setattr(tpip._g1("cpu"), "add", lambda a, b: a)
    scalars, pts = _zeros(48)
    tpip.pippenger_low_memory(scalars[0], pts, chunk=16, c=4)
    assert [s[0] for s in schedules] == ["_pippenger_impl"] * 3


# ---------------------------------------------------------------------------
# K4's round-folded digits and K3b-wide's fused reduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [4, 8, 10])
def test_fused_digits_give_the_jax_bucket_index(data, c):
    """K4 with round offset 2^(c-1): |D| - 1 is the JAX fused schedule's
    bucket r 2^(c-1) + |d| - 1 of entry r * 2N + i, D = 0 where d = 0, and
    D has d's sign."""
    _, _, vecs = data
    nb = 1 << (c - 1)
    rounds = msm_kernels.digit_rounds(c)
    jk1, jk2 = j_split_scalars(jfr.encode(vecs[1]))
    d = np.concatenate([np.asarray(j_signed_digits(jk1, c)), np.asarray(j_signed_digits(jk2, c))], axis=1)
    rid = np.arange(rounds)[:, None]
    want_bucket = np.where(d == 0, rounds * nb, rid * nb + np.abs(d) - 1).reshape(-1)
    m = rounds * 2 * N + 5
    got = msm_kernels.glv_digits(tfr("cpu").encode(vecs[1]), 1, c, m, round_offset=nb)[0]
    assert got.shape == (m,) and not got[rounds * 2 * N :].any()
    got = got[: rounds * 2 * N].numpy()
    assert np.array_equal(np.where(got == 0, rounds * nb, np.abs(got) - 1), want_bucket)
    assert np.array_equal(np.sign(got), np.sign(d.reshape(-1)))
    plain = msm_kernels.glv_digits(tfr("cpu").encode(vecs[1]), 1, c, rounds * 2 * N)[0].numpy()
    assert np.array_equal(plain, d.reshape(-1))
    with pytest.raises(ValueError):
        msm_kernels.glv_digits(tfr("cpu").encode(vecs[1]), 1, c, rounds * 2 * N, round_offset=1 << 30)


@pytest.fixture(scope="module")
def fused_partials(data):
    """The fused schedule's K3a partials of two vectors at c = 4 (33 rounds
    x 8 = 264 buckets in each set)."""
    _, tpts, vecs = data
    c, block = 4, BLOCK
    n = N
    rounds, nb = msm_kernels.digit_rounds(c), 1 << (c - 1)
    m = -(-rounds * 2 * n // block) * block
    scalars = torch.cat([tfr("cpu").encode(vecs[0]), tfr("cpu").encode(vecs[1])], dim=1)
    digits = msm_kernels.glv_digits(scalars, 2, c, m, round_offset=nb)
    entries = msm_kernels.sort_rounds(digits, rounds * nb)
    entries = entries._replace(order=entries.order % (2 * n))
    partials = msm_kernels.bucket_accumulate(entries, *tpip.endo_points(tpts), rounds * nb, block)
    return partials, rounds, nb


def test_fused_reduce_is_per_round_window_sums(fused_partials):
    """K3b-wide's fused mode equals each round's window sum computed apart
    (the set's buckets cut into rounds, K3b's per-round function), and a
    cut into ranges of 1, 2 and 5 rounds changes nothing."""
    partials, rounds, nb = fused_partials
    total = rounds * nb
    got = msm_kernels.plain_bucket_reduce_wide(partials, total, None, nb)
    assert got.inf.shape == (2 * rounds,)
    sums = msm_kernels.plain_bucket_sums(partials, total)
    per_round = msm_kernels._window_sums(JacobianPoints(
        *(t.reshape(18, 2 * rounds, nb) for t in sums[:3]), sums.inf.reshape(2 * rounds, nb)))
    assert all(torch.equal(a, b) for a, b in zip(got, per_round))
    for k in (1, 2, 5):
        cut = msm_kernels.bucket_reduce_wide(partials, total, k * nb, segment=nb)
        assert all(torch.equal(a, b) for a, b in zip(cut, got))
    with pytest.raises(ValueError):
        msm_kernels.bucket_reduce_wide(partials, total, nb + 1, segment=nb)


def _kernel_scans(buckets: JacobianPoints, sb0: int, sn: int, seg: int, cluster: int = 8) -> JacobianPoints:
    """The kernel's per-range suffix scans, lane by lane as its CTAs index
    them (cta_share over the cluster, `per` lanes a segment at a level, lane
    sb0 + (t / per) seg + j, add when j + d < seg; the second scan only the
    lanes j = k 2d, in place), on (18, B) bucket sums. Returns the buffer
    the window sums are read from."""
    def share(n, rank):
        q = -(-n // cluster)
        return range(min(n, rank * q), min(n, (rank + 1) * q))

    bufs = [JacobianPoints(*(t.clone() for t in buckets)), JacobianPoints(*(t.clone() for t in buckets))]
    levels = max(1, (seg - 1).bit_length())
    for step in range(2 * levels):
        lane0 = step >= levels
        i = step - levels if lane0 else step
        src = bufs[(levels - 1) & 1 ^ 1] if lane0 else bufs[i & 1]
        dst = src if lane0 else bufs[(i & 1) ^ 1]
        d = 1 << i
        per = -(-seg // (2 * d)) if lane0 else seg
        lanes, others = [], []
        for rank in range(cluster):
            for t in share((sn // seg) * per, rank):
                j = (t % per) * 2 * d if lane0 else t % per
                lanes.append(sb0 + (t // per) * seg + j)
                others.append(sb0 + (t // per) * seg + j + d if j + d < seg else -1)
        idx = torch.tensor(lanes)
        p = JacobianPoints(*(t[..., idx] for t in src))
        oth = torch.tensor([o if o >= 0 else 0 for o in others])
        q = JacobianPoints(*(t[..., oth] for t in src))
        take = torch.tensor([o >= 0 for o in others])
        q = JacobianPoints(q.x, q.y, q.z, q.inf | ~take)  # no lane d on: add infinity, keep p
        s = point_kernels.plain_add(p, q)
        for k, t in enumerate(dst):
            t[..., idx] = s[k]
    return bufs[(levels - 1) & 1 ^ 1]


def test_kernel_range_scans_model(fused_partials):
    """The kernel's index arithmetic for a range of whole rounds (per-range
    mode) and for the whole set (the last cluster's scans, one segment):
    each segment's first lane is its window sum."""
    partials, rounds, nb = fused_partials
    total = rounds * nb
    sums = msm_kernels.plain_bucket_sums(partials, total)
    set0 = JacobianPoints(sums.x[:, 0], sums.y[:, 0], sums.z[:, 0], sums.inf[0])
    want = msm_kernels.plain_bucket_reduce_wide(partials, total, None, nb)
    for sb0, sn in ((0, total), (2 * nb, 3 * nb), (16 * nb, nb)):
        fin = _kernel_scans(set0, sb0, sn, nb)
        for g in range(sn // nb):
            r = sb0 // nb + g
            assert all(torch.equal(fin[k][..., sb0 + g * nb], want[k][..., r]) for k in range(4))
    one = msm_kernels.plain_bucket_reduce_wide(partials, total)  # seg = nbuckets: one window a set
    fin = _kernel_scans(set0, 0, total, total)
    assert all(torch.equal(fin[k][..., 0], one[k][..., 0]) for k in range(4))


def test_fused_range_buckets_hold_whole_rounds(monkeypatch):
    """The default cut of a fused set: ranges of whole rounds, all sets'
    clusters within what the card holds (one range a set when there are more
    sets than clusters)."""
    for clusters in (1, 7, 16, 100):
        monkeypatch.setattr(msm_kernels, "wide_max_clusters", lambda nb, dev, _c=clusters: _c)
        for c, sets in ((8, 1), (8, 3), (10, 1), (10, 3)):
            rounds, nb = msm_kernels.digit_rounds(c), 1 << (c - 1)
            rb = msm_kernels.wide_range_buckets(rounds * nb, sets, "cpu", segment=nb)
            ranges = -(-rounds * nb // rb)
            assert rb % nb == 0 and rb <= rounds * nb
            assert sets * ranges <= max(clusters, sets)
