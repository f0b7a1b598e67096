"""The slice as a whole on the CPU: the port proves the n = 16 seed-7
arithmetic-widget fixture to the same 800 bytes as the JAX prover and the
pinned digest, its verifier accepts the proof and rejects a tampered one;
SRS, transcript and host modules agree with the JAX package's."""

import copy
import os

import numpy as np
import pytest
import torch

from barretenberg_tpu.plonk import preprocess as j_preprocess
from barretenberg_tpu.srs import test_srs as j_make_srs
from barretenberg_tpu.transcript.keccak import keccak256 as j_keccak256

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields.params import FR_MODULUS
from barretenberg_tpu_torch.plonk import Proof, preprocess
from barretenberg_tpu_torch.plonk.permutation import compute_permutation_lagrange_base
from barretenberg_tpu_torch.polynomials import get_domain
from barretenberg_tpu_torch.srs import ReferenceString, test_srs as make_srs
from barretenberg_tpu_torch.transcript import challenges as fs
from barretenberg_tpu_torch.transcript import keccak as K
from barretenberg_tpu_torch.utils import host_curve

from test_plonk import build_fixture_prover as j_build_fixture_prover

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

GOLDEN = "f9b1f779dea05d9cd75e1e34e69dc3ca20b1b131044e767a52f68a9feb50a990"
N = 16


def _carry_across(jprover):
    """JAX prover fixture -> the port's prover on the same data."""
    jsrs = jprover.reference_string
    m = jsrs.monomials
    srs = convert.reference_string(
        np.asarray(m.x), np.asarray(m.y), np.asarray(m.inf), jsrs.g2_x, device="cpu"
    )
    w = jprover.widgets[0]
    return convert.prover_from_arrays(
        jprover.n,
        srs,
        [np.asarray(a) for a in (jprover.w_l, jprover.w_r, jprover.w_o)],
        [np.asarray(a) for a in (w.q_m, w.q_l, w.q_r, w.q_o, w.q_c)],
        (jprover.sigma_1_mapping, jprover.sigma_2_mapping, jprover.sigma_3_mapping),
    )


def test_prove_matches_jax_bytes_and_verifies():
    """One JAX proof, one port proof and both verifier keys, made once: the
    comparisons below all hang on them (kept in one test so that parallel
    test workers do not each repeat the two proofs)."""
    from barretenberg_tpu.transcript import challenges as jfs

    jprover = j_build_fixture_prover(N, seed=7)
    tprover = _carry_across(jprover)
    verifier = preprocess(_carry_across(jprover))
    jverifier = j_preprocess(j_build_fixture_prover(N, seed=7))
    timings = {}
    tproof = tprover.construct_proof(timings)
    jproof = jprover.construct_proof()

    # the same 800 bytes as the JAX prover, and the pinned digest
    blob = tproof.serialize()
    assert len(blob) == 800
    assert blob == jproof.serialize()
    assert K.keccak256(blob).hex() == GOLDEN
    assert fs.compute_gamma(tproof) == jfs.compute_gamma(jproof)
    assert fs.compute_alpha(tproof) == jfs.compute_alpha(jproof)
    assert fs.compute_evaluation_challenge(tproof) == jfs.compute_evaluation_challenge(jproof)

    # verifier keys agree; each verifier accepts each proof
    assert (verifier.sigma_1_commitment, verifier.sigma_2_commitment, verifier.sigma_3_commitment) == (
        jverifier.sigma_1_commitment, jverifier.sigma_2_commitment, jverifier.sigma_3_commitment)
    assert verifier.verifier_widgets[0].commitments == jverifier.verifier_widgets[0].commitments
    assert verifier.verify_proof(tproof)
    assert verifier.verify_proof(jproof)
    assert jverifier.verify_proof(tproof)

    # tampered proofs are rejected
    for field in ("w_l_eval", "linear_eval", "z_1_shifted_eval"):
        bad = copy.deepcopy(tproof)
        setattr(bad, field, (getattr(bad, field) + 1) % FR_MODULUS)
        assert not verifier.verify_proof(bad), field
    bad = copy.deepcopy(tproof)
    bad.z_commitment = host_curve.g1_add(bad.z_commitment, host_curve.G1_GENERATOR)
    assert not verifier.verify_proof(bad)

    # every phase is timed; quotient_large vanishes above 3n
    assert list(timings) == [
        "sigma_bases", "wire_ifft", "wire_commit", "grand_product", "z_commit",
        "quotient", "quotient_commit", "opening"]
    tail = tprover.fr.decode(tprover.state.quotient_large[:, 3 * N :])
    assert all(v == 0 for v in tail)


def test_srs_equals_the_jax_srs():
    srs, jsrs = make_srs(8, device="cpu"), j_make_srs(8)
    for t, j in zip(srs.monomials, jsrs.monomials):
        assert np.array_equal(t.numpy().astype(np.asarray(j).dtype), np.asarray(j))
    assert srs.g2_x == jsrs.g2_x
    pts = srs.monomials_host()
    tau = 0xA11CE % FR_MODULUS
    assert pts[0] == host_curve.G1_GENERATOR
    assert pts[3] == host_curve.g1_mul(host_curve.G1_GENERATOR, pow(tau, 3, FR_MODULUS))


def test_srs_pairing_check_and_file_round_trip(tmp_path):
    srs = make_srs(8, device="cpu")
    assert srs.srs_pairing_check()
    pts = srs.monomials_host()
    path = str(tmp_path / "transcript.dat")
    ReferenceString.save(path, pts[1:], srs.g2_x)
    loaded = ReferenceString.load(path, 8, device="cpu")
    assert loaded.monomials_host() == pts and loaded.g2_x == srs.g2_x


def test_keccak_known_vectors_and_native_sponge():
    assert K.keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert K.keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    for size in (0, 1, 135, 136, 137, 500):
        d = os.urandom(size)
        assert K.keccak256(d) == K._keccak256_py(d) == j_keccak256(d)


def test_empty_proof_serializes_to_800_bytes():
    assert len(Proof().serialize()) == 800


def test_sigma_lagrange_base_rejects_malformed_mapping():
    d = get_domain(4, "cpu")
    with pytest.raises(ValueError):
        compute_permutation_lagrange_base(np.array([0, 1, 2, 3 << 30], dtype=np.uint32), d)
    with pytest.raises(ValueError):
        compute_permutation_lagrange_base(np.array([0, 1, 2, 9], dtype=np.uint32), d)
