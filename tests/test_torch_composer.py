"""The circuit front end on the CPU: the port's composers end in the same
state as the JAX package's for the JAX tests' circuits and the four bench
circuits at full size (every variable, wire, selector, q_oo, MiMC selector,
merge count and sigma mapping, and what `preprocess` hands the prover),
and prove the JAX tests' small circuits to the JAX prover's bytes; the
port's verifier accepts them, and rejects unsatisfied circuits and
tampered proofs. Tolerance 0 throughout."""

import copy
import types

import numpy as np
import pytest
import torch

import barretenberg_tpu.composer.bool as j_bool
import barretenberg_tpu.composer.extended as j_extended
import barretenberg_tpu.composer.mimc as j_mimc
import barretenberg_tpu.composer.standard as j_standard
from barretenberg_tpu.plonk import preprocess as j_preprocess

import barretenberg_tpu_torch.composer.standard as t_standard
from barretenberg_tpu_torch.composer import StandardComposer
from barretenberg_tpu_torch.fields.params import FR_MODULUS as P
from barretenberg_tpu_torch.fixtures import BENCH_CIRCUITS, bench_circuit
from barretenberg_tpu_torch.plonk import preprocess
from barretenberg_tpu_torch.utils import host_curve

from torch_circuits import COMPOSER_CIRCUITS, JAX, PORT, STDLIB_CIRCUITS

torch.set_num_threads(1)

# gates of the bench circuits after create_dummy_gates (BENCH_DETAILS.json),
# and the prover's n (the extended circuit's 5,004 gates merge to 2,504)
BENCH_GATES = {"sha256": (65167, 1 << 16), "mimc": (2917, 1 << 12),
               "extended": (5004, 1 << 12), "bool": (2203, 1 << 12)}


class _CapturedProver:
    """Stands in for the Prover that `preprocess` builds: records what the
    composer hands it (host values, not device tensors)."""

    def __init__(self, n, reference_string=None, device=None):
        self.n = n
        self.widgets = []
        self.fr = types.SimpleNamespace(encode=list)

    def state(self) -> dict:
        return {
            "n": self.n,
            "sigmas": [np.asarray(m).tolist() for m in
                       (self.sigma_1_mapping, self.sigma_2_mapping, self.sigma_3_mapping)],
            "wires": [list(w) for w in (self.w_l, self.w_r, self.w_o)],
            "widgets": [(type(w).__name__, {k: v for k, v in vars(w).items() if not k.startswith("_")})
                        for w in self.widgets],
        }


def captured_preprocess(ctx, monkeypatch) -> dict:
    """Runs the composer's own preprocess (padding, merging, sigma mappings,
    selector columns) with the Prover and the field encoding replaced by
    host recorders, on either package."""
    if type(ctx).__module__.startswith("barretenberg_tpu_torch."):
        monkeypatch.setattr(t_standard, "Prover", _CapturedProver)
    else:
        monkeypatch.setattr(j_standard, "Prover", _CapturedProver)
        for mod in (j_standard, j_bool, j_mimc, j_extended):
            monkeypatch.setattr(mod, "fr", types.SimpleNamespace(encode=list, p=P))
    return ctx.preprocess(reference_string=object()).state()


def assert_same_composers(jctx, tctx, monkeypatch):
    assert type(tctx).__name__ == type(jctx).__name__
    assert vars(tctx) == vars(jctx)  # after create_dummy_gates
    assert tctx.check_circuit() == jctx.check_circuit()
    assert vars(tctx) == vars(jctx)
    tstate = captured_preprocess(tctx, monkeypatch)
    jstate = captured_preprocess(jctx, monkeypatch)
    assert vars(tctx) == vars(jctx)  # after padding (and merging)
    assert tstate == jstate
    n = tstate["n"]
    assert n & (n - 1) == 0 and len(tstate["wires"][0]) == n
    return tstate


@pytest.mark.parametrize("name", sorted(COMPOSER_CIRCUITS) + sorted(STDLIB_CIRCUITS))
def test_composer_state_equals_jax(name, monkeypatch):
    build = {**COMPOSER_CIRCUITS, **STDLIB_CIRCUITS}[name]
    jctx, jvals = build(JAX)
    tctx, tvals = build(PORT)
    assert tvals == jvals
    state = assert_same_composers(jctx, tctx, monkeypatch)
    kinds = [w for w, _ in state["widgets"]]
    assert kinds[0] == "ProverArithmeticWidget"
    if name.startswith("extended"):
        # the sequential widget shares the arithmetic widget's alpha power
        assert kinds == ["ProverArithmeticWidget", "ProverSequentialWidget", "ProverBoolWidget"]
        assert tctx.merged_count == jctx.merged_count and tctx.deleted_count == jctx.deleted_count


@pytest.mark.parametrize("name", sorted(BENCH_CIRCUITS))
def test_bench_composer_state_equals_jax(name, monkeypatch):
    """The four bench circuits at full size (host Python only)."""
    jctx = bench_circuit(name, JAX.composer, JAX.stdlib)
    tctx = bench_circuit(name)
    assert tctx.n == jctx.n == BENCH_GATES[name][0]
    state = assert_same_composers(jctx, tctx, monkeypatch)
    assert state["n"] == BENCH_GATES[name][1]
    if name == "extended":
        assert tctx.merged_count > 0 and tctx.deleted_count > 0


def test_preprocess_device():
    """preprocess builds its prover on the card by default; device="cpu"
    runs the plain versions; without a card nothing falls back."""
    ctx, _ = COMPOSER_CIRCUITS["standard"](PORT)
    prover = copy.deepcopy(ctx).preprocess(device="cpu")
    assert prover.device == torch.device("cpu") and prover.n == 16
    assert prover.w_l.device == prover.widgets[0].q_m.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            copy.deepcopy(ctx).preprocess()
        with pytest.raises(RuntimeError):
            StandardComposer().preprocess()


def _tampered(proof):
    """Proofs that differ from `proof` in one evaluation or commitment."""
    out = []
    for field in ("w_l_eval", "w_o_eval", "linear_eval", "z_1_shifted_eval", "w_o_shifted_eval",
                  "q_mimc_coefficient_eval"):
        bad = copy.deepcopy(proof)
        setattr(bad, field, (getattr(bad, field) + 1) % P)
        out.append((field, bad))
    bad = copy.deepcopy(proof)
    bad.w_o_commitment = host_curve.g1_add(bad.w_o_commitment, host_curve.G1_GENERATOR)
    out.append(("w_o_commitment", bad))
    return out


def _prove(ctx, **kw):
    """(verifier, proof) of a composer's circuit: the port's with
    device="cpu", the JAX package's without."""
    prover = ctx.preprocess(**kw)
    verifier = (preprocess if kw else j_preprocess)(prover)
    return verifier, prover.construct_proof()


def assert_proofs_equal(jctx, tctx, used: dict):
    """The port proves a circuit to the JAX prover's bytes and verifier key;
    its verifier accepts the proof and rejects every tampered copy whose
    changed field it reads (`used`: the fields only some widgets read)."""
    jverifier, jproof = _prove(jctx)
    verifier, proof = _prove(tctx, device="cpu")
    assert proof.serialize() == jproof.serialize()
    assert vars(proof) == vars(jproof)
    assert [w.commitments for w in verifier.verifier_widgets] == [
        w.commitments for w in jverifier.verifier_widgets]
    assert verifier.verify_proof(proof)
    for field, bad in _tampered(proof):
        assert verifier.verify_proof(bad) == (not used.get(field, True)), field


# The JAX tests' small satisfiable circuits (n = 16; their sizes are the
# ones the JAX tests compile), each widget combination once. Marked slow:
# the JAX prove of each takes 2-4 minutes on a CPU (its naive MSMs run
# eagerly), the port's about half a minute; the default run holds one JAX
# prove with every widget (test_torch_widgets.py) and the composers' state.
PROVED = ("standard", "bool", "mimc", "extended_chain")


@pytest.mark.slow
@pytest.mark.parametrize("name", PROVED)
def test_proof_bytes_equal_jax(name):
    jctx, _ = COMPOSER_CIRCUITS[name](JAX)
    tctx, _ = COMPOSER_CIRCUITS[name](PORT)
    assert_proofs_equal(jctx, tctx, {"w_o_shifted_eval": name in ("mimc", "extended_chain"),
                                     "q_mimc_coefficient_eval": name == "mimc"})


@pytest.mark.parametrize("name", ("standard_unsatisfied", "bool_tampered", "mimc_tampered",
                                  "extended_bad_witness"))
def test_unsatisfied_circuit_fails_to_verify(name):
    tctx, _ = COMPOSER_CIRCUITS[name](PORT)
    verifier, proof = _prove(tctx, device="cpu")
    assert not verifier.verify_proof(proof)
