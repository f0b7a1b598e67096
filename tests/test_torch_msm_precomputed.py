"""The precomputed-table Pippenger schedule of the port against the JAX
package (table rows and Jacobian coordinates limb for limb) and the host
oracle, on the CPU: K3f ``table_rows`` and K3b-wide ``bucket_reduce_wide``
through their plain versions, the prover's commitments through the table,
and ``pippenger_low_memory``. The JAX side runs only the shapes
``tests/test_msm.py`` compiles (N = 64, c = 8, block 16)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.groups.g1 import host_to_affine_points as j_host_to_affine
from barretenberg_tpu.msm.pippenger import (
    generate_pippenger_point_table as j_generate_table,
    pippenger_precomputed as j_pippenger_precomputed,
)

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fr as tfr
from barretenberg_tpu_torch.fields.params import FQ_CUBE_ROOT, FQ_MODULUS, FR_MODULUS
from barretenberg_tpu_torch.groups import JacobianPoints
from barretenberg_tpu_torch.groups.g1 import g1 as tg1, host_to_affine_points, jacobian_to_host, points_to_host
from barretenberg_tpu_torch.kernels import msm_kernels, point_kernels
from barretenberg_tpu_torch.msm import (
    batched_msm,
    generate_pippenger_point_table,
    pippenger,
    pippenger_low_memory,
    pippenger_precomputed,
)
from barretenberg_tpu_torch.msm.pippenger import precomputed_digits
from barretenberg_tpu_torch.plonk.prover import Prover
from barretenberg_tpu_torch.srs import test_srs
from barretenberg_tpu_torch.transcript.keccak import keccak256
from barretenberg_tpu_torch.utils import host_curve

from chip_smoke import GOLDEN_DIGEST, fixture_arrays

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

N, C, BLOCK = 64, 8, 16  # the configuration tests/test_msm.py compiles
P = FR_MODULUS


def _same(t, j) -> bool:
    return all(np.array_equal(tc.numpy().astype(np.asarray(jc).dtype), np.asarray(jc)) for tc, jc in zip(t, j))


@pytest.fixture(scope="module")
def data():
    """64 points (lane 7 repeats lane 6, lane 5 is at infinity), scalars
    with 0, 1, r-1 in front, and the port's table of the points."""
    rng = np.random.default_rng(34)
    g = host_curve.G1_GENERATOR
    host_pts = [host_curve.g1_mul(g, int(k)) for k in rng.integers(1, 1 << 30, size=N)]
    host_pts[5] = None
    host_pts[7] = host_pts[6]
    scalars = [0, 1, P - 1] + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(N - 3)]
    jpts = j_host_to_affine(host_pts)
    jscal = jfr.encode(scalars)
    tpts = convert.affine_points(*(np.asarray(c) for c in jpts), device="cpu")
    table = generate_pippenger_point_table(tpts, c=C)
    return host_pts, scalars, convert.field_tensor(jscal, "cpu"), tpts, jpts, jscal, table


@pytest.fixture(scope="module")
def jax_side(data):
    """The JAX package's table and precomputed MSM of the same inputs."""
    _, _, _, _, jpts, jscal, _ = data
    jtable = j_generate_table(jpts, c=C)
    return jtable, j_pippenger_precomputed(jscal, jtable, block=BLOCK)


def test_table_rows_match_jax(data, jax_side):
    table, (jtable, _) = data[-1], jax_side
    assert (table.c, table.rounds, table.n) == (jtable.c, jtable.rounds, jtable.n) == (C, 17, N)
    assert _same(table.affine(), (jtable.x, jtable.y, jtable.inf))


def test_table_entries_layout(data):
    """Round r's entries: row r's points, then their endomorphism images
    (beta x, -y), then dead entries up to the block."""
    host_pts, *_, table = data
    rows = table.entries(128)
    assert rows.shape == (table.rounds * 2 * N, point_kernels.ROW_WORDS)
    ent = points_to_host(point_kernels.row_points(rows))
    for r in (0, 1, table.rounds - 1):
        shift = 1 << (r * C)
        row = [host_curve.g1_mul(p, shift) if p else None for p in host_pts]
        assert ent[r * 2 * N : r * 2 * N + N] == row
        endo = [(FQ_CUBE_ROOT * p[0] % FQ_MODULUS, (-p[1]) % FQ_MODULUS) if p else None for p in row]
        assert ent[r * 2 * N + N : (r + 1) * 2 * N] == endo
    padded = table.entries(BLOCK * 3)
    assert padded.shape[0] % (BLOCK * 3) == 0
    assert bool(point_kernels.row_points(padded[rows.shape[0] :]).inf.all())


def test_precomputed_msm_matches_jax_and_host(data, jax_side):
    host_pts, scalars, tscal, *_, table = data
    jres = jax_side[1]
    got = pippenger_precomputed(tscal, table, block=BLOCK)
    assert _same(got, jres)
    assert jacobian_to_host(got) == [host_curve.g1_msm(host_pts, scalars)]


@pytest.mark.parametrize("block", [8, 16, 128, None])
def test_precomputed_msm_at_any_block_matches_jax_and_host(data, jax_side, block):
    """K3a's walk length changes the partials' grouping, not the MSM: at
    blocks 8, 16 and 128, and at the block the call picks itself (None), the
    precomputed MSM equals the JAX package's at its block 16 in affine
    form, and the host oracle."""
    host_pts, scalars, tscal, *_, table = data
    want = jacobian_to_host(convert.jacobian_points(*(np.asarray(t) for t in jax_side[1]), device="cpu"))
    got = jacobian_to_host(pippenger_precomputed(tscal, table, block=block))
    assert got == want == [host_curve.g1_msm(host_pts, scalars)]


def test_accumulate_block_choice():
    """The block a call picks is one of 8, 16, 32, 64, 128, never grows as
    the call's entry count falls, is 128 once the walks of 128 fill the
    card and 8 when even walks of 8 do not; a CPU batch picks it for the
    card's nominal capacity."""
    for capacity in (1, 1000, msm_kernels.NOMINAL_CAPACITY, 1 << 20):
        prev = 128
        for entries in sorted({int(v) for v in np.geomspace(1, 1 << 30, 400)} | {capacity * b for b in (8, 64, 128)},
                              reverse=True):
            block = msm_kernels.accumulate_block(entries, capacity)
            assert block in (8, 16, 32, 64, 128) and block <= prev
            prev = block
        assert msm_kernels.accumulate_block(128 * capacity, capacity) == 128
        assert msm_kernels.accumulate_block(8 * capacity - 1, capacity) == 8
    assert msm_kernels.accumulate_capacity(torch.device("cpu")) == msm_kernels.NOMINAL_CAPACITY


def test_table_rows_plain_is_the_dbl_loop(data):
    """K3f's plain version against c lane-wise doublings per row, and its
    rows against the host group law."""
    host_pts, _, _, tpts, *_ = data
    rows, c, m = 4, 3, 8
    pts = tg1("cpu").take_affine(tpts, torch.arange(m))
    got = point_kernels.plain_table_rows(pts, rows, c)
    acc = tg1("cpu").to_jacobian(pts)
    for r in range(1, rows):
        for _ in range(c):
            acc = point_kernels.dbl(acc)
        lanes = slice((r - 1) * m, r * m)
        assert all(torch.equal(g[..., lanes], w) for g, w in zip(got, acc))
        want = [host_curve.g1_mul(p, 1 << (r * c)) if p else None for p in host_pts[:m]]
        assert jacobian_to_host(JacobianPoints(*(t[..., lanes] for t in got))) == want
    assert torch.equal(point_kernels.table_rows(pts, rows, c).x, got.x)
    assert point_kernels.launch_counts["table_rows"] == 0  # the CPU never launches


def _edge_partials(table, tscal):
    """Two bucket sets through K3a's plain version: the MSM's own set, and
    a set whose live entries all fall in bucket 2 (one bucket holds every
    partial), with its digits."""
    nb = 1 << (C - 1)
    rows = table.entries(BLOCK)
    m = rows.shape[0]
    digits = precomputed_digits([tscal], C, m)
    heavy = torch.zeros(m, dtype=torch.int32)
    heavy[: 3 * N : 3] = 3
    heavy[1 : 3 * N : 3] = -3
    digits = torch.cat([digits, heavy.unsqueeze(0)])
    entries = msm_kernels.sort_rounds(digits, nb)
    return msm_kernels.bucket_accumulate_rows(entries, rows, nb, BLOCK), nb, digits, rows


@pytest.mark.parametrize("range_buckets", [None, 1, 2, 7, 8, 64])
def test_bucket_reduce_wide_ranges_match_uncut(data, range_buckets):
    """K3b-wide's plain version with each set cut into segment-aligned
    ranges (1, 2, 7, 8, 64 buckets, as the kernel's clusters cut it; None
    uncut) equals the uncut K3b plain version limb for limb, on the MSM's
    set and on the one-bucket set."""
    _, _, tscal, *_, table = data
    partials, nb, _, _ = _edge_partials(table, tscal)
    assert int((partials.bucket[1] == 2).sum()) > 1  # the heavy bucket spans blocks
    got = msm_kernels.plain_bucket_reduce_wide(partials, nb, range_buckets)
    want = msm_kernels.plain_bucket_reduce(partials, nb)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(msm_kernels.bucket_reduce_wide(partials, nb, range_buckets).x, want.x)


@pytest.mark.parametrize("range_buckets", [None, 1, 7, 64])
def test_bucket_reduce_wide_on_empty_and_dead_sets(data, range_buckets):
    """A set of no live entry (every digit 0: every slot dead) and a set whose
    live entries are all points at infinity (digits only on point 5's
    entries): both sums are infinity, cut or uncut, and equal the uncut K3b
    plain version."""
    *_, table = data
    nb = 1 << (C - 1)
    rows = table.entries(BLOCK)
    m = rows.shape[0]
    dead = torch.zeros((2, m), dtype=torch.int32)
    at_inf = torch.arange(m) % (2 * N) % N == 5  # point 5 and its endomorphism image, every round
    dead[1, at_inf] = torch.arange(int(at_inf.sum()), dtype=torch.int32) % (2 * nb + 1) - nb
    partials = msm_kernels.bucket_accumulate_rows(msm_kernels.sort_rounds(dead, nb), rows, nb, BLOCK)
    assert not (partials.bucket[0] < nb).any() and (partials.bucket[1] < nb).any()
    got = msm_kernels.plain_bucket_reduce_wide(partials, nb, range_buckets)
    assert all(torch.equal(g, w) for g, w in zip(got, msm_kernels.plain_bucket_reduce(partials, nb)))
    assert jacobian_to_host(got) == [None, None]


def _partials_4096():
    """c = 13's 4096 buckets at a tiny partial count: one set of 24 slots,
    13 partials in buckets near both ends (0, 4094, 4095), at the middle
    (2047, 2048) and a run of five in bucket 7, then dead slots; with the
    host points of every slot."""
    nb, k = 4096, 24
    buckets = [0, 0, 7, 7, 7, 7, 7, 900, 2047, 2048, 4094, 4095, 4095] + [nb] * 11
    rng = np.random.default_rng(88)
    host = [host_curve.g1_mul(host_curve.G1_GENERATOR, int(v)) for v in rng.integers(1, 1 << 40, size=k)]
    pts = tg1("cpu").to_jacobian(host_to_affine_points(host, "cpu"))
    live = torch.tensor([b < nb for b in buckets])
    pts = JacobianPoints(*(torch.where(live, t, 0) for t in pts[:3]), ~live)
    return msm_kernels.Partials(torch.tensor([buckets], dtype=torch.int32), pts), nb, buckets, host


@pytest.mark.parametrize("range_buckets", [7, 64, 1000])
def test_bucket_sums_at_4096_buckets_do_not_depend_on_the_cut(range_buckets):
    partials, nb, _, _ = _partials_4096()
    got = msm_kernels.plain_bucket_sums(partials, nb, range_buckets)
    assert all(torch.equal(g, w) for g, w in zip(got, msm_kernels.plain_bucket_sums(partials, nb)))


def test_bucket_reduce_wide_at_4096_buckets():
    """The window sum sum_b (b + 1) S_b over 4096 buckets against the host
    (the suffix scans' 24 levels; ~15 s of plain adds on the CPU)."""
    partials, nb, buckets, host = _partials_4096()
    want = None
    for j, b in enumerate(buckets):
        if b < nb:
            want = host_curve.g1_add(want, host_curve.g1_mul(host[j], b + 1))
    assert jacobian_to_host(msm_kernels.bucket_reduce_wide(partials, nb)) == [want]


def test_wide_merge_depth_lists_each_levels_lanes():
    """K3b-wide lists a CTA's slots by merge depth (csrc/msm_kernels.cu
    ``merge_depth``: min(trailing zeros of end - t, bit length of t - first))
    and runs level i over the slots deeper than i: in a Python model, those
    are exactly the lanes level i of the merge writes (end - t a multiple of
    2^(i+1), t - first >= 2^i), and the levels add up to s - 1 per segment
    of s partials."""
    def depth(t, first, end):
        q = end - t
        return min(32 if q == 0 else (q & -q).bit_length() - 1, (t - first).bit_length())

    for s in range(1, 140):
        first, end = 5, 5 + s - 1
        lanes = range(first, end + 1)
        levels = max(1, (s - 1).bit_length())
        for i in range(levels + 1):
            d = 1 << i
            writes = {t for t in lanes if t - first >= d and (end - t) % (2 * d) == 0}
            assert writes == {t for t in lanes if depth(t, first, end) > i}
        assert sum(depth(t, first, end) for t in lanes) == s - 1


def test_bucket_reduce_wide_matches_host_oracle(data):
    host_pts, scalars, tscal, *_, table = data
    partials, nb, digits, rows = _edge_partials(table, tscal)
    got = jacobian_to_host(msm_kernels.plain_bucket_reduce_wide(partials, nb, 1))
    ent = points_to_host(point_kernels.row_points(rows))
    heavy = host_curve.g1_msm(ent, [int(d) % P for d in digits[1].tolist()])
    assert got == [host_curve.g1_msm(host_pts, scalars), heavy]


def test_prover_commits_through_the_table_for_2e10_to_2e18():
    stub = object.__new__(Prover)
    stub.reference_string = SimpleNamespace(pippenger_table=lambda n: ("table", n))
    for log2n, on in ((9, False), (10, True), (16, True), (18, True), (19, False)):
        stub.n = 1 << log2n
        assert stub._precomputed_table() == (("table", 1 << log2n) if on else None)


def test_commit_batch_through_the_table_at_2e10():
    """At n = 2^10 the prover's commitments (two in one batch, and one
    alone) go through the SRS's cached table and equal the host oracle's and
    batched_msm's (the naive MSM below 2^12 points)."""
    n = 1 << 10
    srs = test_srs(n, device="cpu")
    prover = Prover(n, srs, device="cpu")
    assert prover._precomputed_table() is srs.pippenger_table(n)
    rng = np.random.default_rng(51)
    fr = tfr("cpu")
    vals = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)] for _ in range(2)]
    vals[1][:3] = [0, 1, P - 1]
    coeffs = [fr.encode(v) for v in vals]
    got = prover.commit_batch(coeffs)
    assert got[0] == host_curve.g1_msm(srs.monomials_host()[:n], vals[0])
    naive = points_to_host(tg1("cpu").batch_normalize(batched_msm(coeffs[1:], prover.monomials)))
    assert [got[1]] == naive
    assert prover.commit(coeffs[1]) == got[1]


def test_golden_proof_skips_the_table():
    """n = 16 stays on the naive MSM and keeps the pinned digest."""
    srs = test_srs(16, device="cpu")
    wires, selectors, sigmas = fixture_arrays(16, 7)
    prover = convert.prover_from_arrays(16, srs, wires, selectors, sigmas)
    assert prover._precomputed_table() is None
    assert keccak256(prover.construct_proof().serialize()).hex() == GOLDEN_DIGEST


def test_low_memory_matches_chunk_sums_and_host(data):
    """``pippenger_low_memory`` at the shape of the JAX package's own test
    (chunk 16, c = 8): the in-order sum of each chunk's rounds-batched
    Pippenger (block 128; held against the JAX package's per-round path by
    tests/test_torch_msm.py), and the host oracle. The JAX function itself
    takes minutes per call on the CPU, so it is not run here."""
    host_pts, scalars, tscal, tpts, *_ = data
    got = pippenger_low_memory(tscal, tpts, chunk=16, c=C)
    g1 = tg1("cpu")
    want = None
    for lo in range(0, N, 16):
        idx = torch.arange(lo, lo + 16)
        part = pippenger(tscal[:, lo : lo + 16], g1.take_affine(tpts, idx), c=C, block=128)
        want = part if want is None else g1.add(want, part)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert jacobian_to_host(got) == [host_curve.g1_msm(host_pts, scalars)]
    assert all(torch.equal(g, w) for g, w in zip(pippenger_low_memory(tscal, tpts, chunk=N, c=C), pippenger(tscal, tpts, c=C)))
