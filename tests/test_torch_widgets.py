"""The Bool, Sequential and MiMC widgets on the CPU: the crosscheck fixture
(`fixtures.crosscheck_prover`, the twin of the reference C++ prover's
fixture) proves to `CROSSCHECK.json`'s bytes through the port alone, a
prover carried across from the JAX package with every widget
(`convert.prover_from_arrays`) gives the JAX prover's bytes, and the
verifier widgets' scalars and batch evaluations equal the JAX package's.
Tolerance 0."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as j_fr
from barretenberg_tpu.plonk import Prover as JProver
from barretenberg_tpu.plonk import widgets as jw
from barretenberg_tpu.srs import test_srs as j_make_srs

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields.params import FR_MODULUS as P
from barretenberg_tpu_torch.fixtures import CROSSCHECK_SHA256, crosscheck_prover
from barretenberg_tpu_torch.plonk import Proof
from barretenberg_tpu_torch.plonk import widgets as tw
from barretenberg_tpu_torch.srs import test_srs as make_srs
from barretenberg_tpu_torch.utils import host_curve

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_crosscheck_constants_match_the_record():
    cases = json.loads((ROOT / "CROSSCHECK.json").read_text())["cases"]
    recorded = {(c["n"], c["with_bool"]): c["proof_sha256"] for c in cases if c["n"] <= 256}
    assert recorded == CROSSCHECK_SHA256


@pytest.mark.parametrize("n, with_bool", sorted(CROSSCHECK_SHA256), ids=["arithmetic_n16", "bool_n256"])
def test_crosscheck_fixture_bytes(n, with_bool):
    """The reference C++ prover's bytes, reached without running JAX."""
    prover = crosscheck_prover(make_srs(256, device="cpu"), n, with_bool)
    assert [type(w).__name__ for w in prover.widgets] == (
        ["ProverArithmeticWidget"] + ["ProverBoolWidget"] * with_bool)
    proof = prover.construct_proof()
    assert hashlib.sha256(proof.serialize()).hexdigest() == CROSSCHECK_SHA256[(n, with_bool)]


def _selector_arrays(n: int, rng) -> dict:
    """Random selector columns for every widget (value lists)."""
    def col(density):
        return [int(v) if rng.random() < density else 0
                for v in rng.integers(1, 1 << 62, size=n)]
    return {
        "q_oo": col(0.5),
        "bool": [[int(v) for v in rng.integers(0, 2, size=n)] for _ in range(3)],
        "mimc": [[int(v) for v in rng.integers(0, 2, size=n)], col(0.7)],
    }


def test_prover_from_arrays_with_every_widget_gives_jax_bytes():
    """Arithmetic, Sequential, Bool and MiMC widgets in the composers' order
    on the n = 16 crosscheck circuit (the extra selectors random, so the
    proof need not verify): the port's bytes and every proof evaluation
    equal the JAX prover's."""
    n = 16
    rng = np.random.default_rng(10)
    extra = _selector_arrays(n, rng)
    jsrs = j_make_srs(256)
    base = crosscheck_prover(make_srs(256, device="cpu"), n)
    arith = [base.fr.decode(getattr(base.widgets[0], q)) for q in ("q_m", "q_l", "q_r", "q_o", "q_c")]
    wires = [base.fr.decode(w) for w in (base.w_l, base.w_r, base.w_o)]
    sigmas = (base.sigma_1_mapping, base.sigma_2_mapping, base.sigma_3_mapping)

    jprover = JProver(n, jsrs)
    jprover.w_l, jprover.w_r, jprover.w_o = (j_fr.encode(w) for w in wires)
    jprover.sigma_1_mapping, jprover.sigma_2_mapping, jprover.sigma_3_mapping = sigmas
    jprover.widgets = [
        jw.ProverArithmeticWidget(*(j_fr.encode(q) for q in arith)),
        jw.ProverSequentialWidget(j_fr.encode(extra["q_oo"])),
        jw.ProverBoolWidget(*(j_fr.encode(q) for q in extra["bool"])),
        jw.ProverMiMCWidget(*(j_fr.encode(q) for q in extra["mimc"])),
    ]
    m = jsrs.monomials
    srs = convert.reference_string(np.asarray(m.x), np.asarray(m.y), np.asarray(m.inf), jsrs.g2_x, device="cpu")
    arrays = lambda w: np.asarray(w)  # noqa: E731
    tprover = convert.prover_from_arrays(
        n, srs,
        [arrays(w) for w in (jprover.w_l, jprover.w_r, jprover.w_o)],
        [arrays(q) for q in (jprover.widgets[0].q_m, jprover.widgets[0].q_l, jprover.widgets[0].q_r,
                             jprover.widgets[0].q_o, jprover.widgets[0].q_c)],
        sigmas,
        q_oo=arrays(jprover.widgets[1].q_o_next),
        bool_selectors=[arrays(q) for q in (jprover.widgets[2].q_bl, jprover.widgets[2].q_br,
                                            jprover.widgets[2].q_bo)],
        mimc_selectors=[arrays(jprover.widgets[3].q_mimc_selector),
                        arrays(jprover.widgets[3].q_mimc_coefficient)],
    )
    assert [type(w).__name__ for w in tprover.widgets] == [type(w).__name__ for w in jprover.widgets]
    tproof = tprover.construct_proof()
    jproof = jprover.construct_proof()
    assert tproof.serialize() == jproof.serialize()
    assert vars(tproof) == vars(jproof)


def _random_proof(rng) -> Proof:
    proof = Proof()
    for name, value in vars(Proof()).items():
        if isinstance(value, int):
            setattr(proof, name, int.from_bytes(rng.bytes(32), "little") % P)
    return proof


def _points(rng, k: int) -> list:
    return [host_curve.g1_mul(host_curve.G1_GENERATOR, int(rng.integers(1, 1 << 62))) for _ in range(k)]


@pytest.mark.parametrize("kind, count", [("Arithmetic", 5), ("Bool", 3), ("Sequential", 1), ("MiMC", 2)])
def test_verifier_widgets_equal_jax(kind, count):
    """The verifier widgets' commitment checks, batch evaluation and MSM
    inputs, on random proof scalars, with a (0, 0) commitment where the
    JAX widget accepts one."""
    rng = np.random.default_rng(count)
    proof = _random_proof(rng)
    coeffs = {k: int.from_bytes(rng.bytes(32), "little") % P
              for k in ("alpha_base", "alpha_step", "nu_base", "nu_step", "linear_nu")}
    for commitments in (_points(rng, count), [(0, 0)] + _points(rng, count - 1)):
        if kind == "Arithmetic" and commitments[0] == (0, 0):
            continue
        t = getattr(tw, f"Verifier{kind}Widget")(commitments)
        j = getattr(jw, f"Verifier{kind}Widget")(commitments)
        assert t.dependencies == j.dependencies
        assert t.verify_instance_commitments() == j.verify_instance_commitments()
        assert t.compute_batch_evaluation_contribution(7, 11, 13, proof) == (
            j.compute_batch_evaluation_contribution(7, 11, 13, proof))
        tp, ts, jp, js = [], [], [], []
        assert t.append_scalar_multiplication_inputs(coeffs, proof, tp, ts) == (
            j.append_scalar_multiplication_inputs(coeffs, proof, jp, js))
        assert (tp, ts) == (jp, js)
