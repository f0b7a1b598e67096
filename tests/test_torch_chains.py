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


# ---------------------------------------------------------------------------
# K3c's cooperative step, modelled from its CUDA source
# ---------------------------------------------------------------------------
# csrc/msm_kernels.cu runs each point operation of a chain on a group of
# COMBINE_GROUP lanes: per level, lane i computes fe_mul of the i-th entry
# of each fe_role list (a spare lane the first), every lane takes the
# level's products by shuffles (fe_group_from) and computes the sums between
# levels itself. The tests below translate coop_dbl / coop_add from the
# source into Python line by line, run them with each product on 30-bit
# limbs through test_torch_field_bounds' model of fe_mul (the kernel's only
# 64-bit accumulators; K3c adds none), and hold the result limb for limb
# against the plain versions, the JAX Horner loop and the host oracle.
import os  # noqa: E402
import re  # noqa: E402

from test_torch_field_bounds import fe_mul_model, limbs  # noqa: E402

from barretenberg_tpu_torch.fields.params import R_INTERNAL  # noqa: E402
from barretenberg_tpu_torch.kernels.point_kernels import plain_add, plain_dbl  # noqa: E402

_MSM_SRC = os.path.join(os.path.dirname(msm_kernels.__file__), "..", "csrc", "msm_kernels.cu")


def _source() -> str:
    with open(_MSM_SRC) as f:
        return f.read()


def _body(src: str, header: str) -> str:
    start = src.index(header)
    i = src.index("{", start) + 1
    depth = 1
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j]
    raise ValueError(header)


def _statements(body: str):
    """(indent change, statement) pairs: block braces at paren depth 0."""
    body = re.sub(r"//[^\n]*", "", body)
    out, cur, depth = [], "", 0
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if depth == 0 and ch in ";{}":
            if cur.strip() or ch == "{":
                out.append((ch, " ".join(cur.split())))
            if ch == "}":
                out.append(("}", ""))
            cur = ""
        else:
            cur += ch
    return out


def _split_top(s: str) -> list:
    parts, cur, depth = [], "", 0
    for ch in s:
        depth += {"(": 1, "[": 1, ")": -1, "]": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def _translate(src: str, name: str) -> str:
    """coop_dbl / coop_add as Python: `fc` dropped, fe_role<N>(role, {...})
    -> fe_role([...]), declarations split into assignments, && / || / ! /
    ?: as Python, coop_dbl's reference parameters returned."""
    header = {"coop_dbl": "void coop_dbl(", "coop_add": "jpt coop_add("}[name]
    lines = [f"def {name}({'x, y, z' if name == 'coop_dbl' else 'p1, p2'}):"]
    indent = 1
    for kind, st in _statements(_body(src, header)):
        if kind == "}":
            indent -= 1
            continue
        st = re.sub(r", fc\)", ")", st)
        st = re.sub(r"fe_role<\d+>\(role, \{", "fe_role([", st).replace("})", "])")
        st = re.sub(r"__any_sync\(0xffffffffu, (\w+)\)", r"\1", st)
        st = st.replace("&&", " and ").replace("||", " or ")
        st = re.sub(r"!(?!=)", " not ", st)
        st = re.sub(r"(\S+) \? (\S+) : \((\S+) \? (\S+) : (\S+)\)", r"(\2 if \1 else (\4 if \3 else \5))", st)
        if kind == "{":
            m = re.fullmatch(r"if \((.*)\)", st)
            lines.append("    " * indent + f"if {m.group(1)}:")
            indent += 1
            continue
        call = re.fullmatch(r"coop_dbl\((\w+), (\w+), (\w+), role\)", st)
        decl = re.fullmatch(r"(?:const )?(?:fe|bool|jpt) (.*)", st)
        if call:
            stmts = [f"{', '.join(call.groups())} = coop_dbl({', '.join(call.groups())})"]
        elif st == "jpt out" or (decl and decl.group(1) == "out"):
            stmts = ["out = Jpt()"]
        elif decl:
            stmts = [d.lstrip("&").replace("= ", "= ", 1) for d in _split_top(decl.group(1))]
            stmts = [re.sub(r"^&?(\w+) = ", r"\1 = ", d) for d in stmts]
        else:
            stmts = [st]
        lines += ["    " * indent + s for s in stmts]
    if name == "coop_dbl":
        lines.append("    return x, y, z")
    return "\n".join(lines)


class Jpt:
    def __init__(self, x=0, y=0, z=0, inf=False):
        self.x, self.y, self.z, self.inf = x, y, z, inf


class CoopModel:
    """The group's lanes in Python: a value every lane holds alike is an int
    (the internal Montgomery form, < q); a level's products are a list, one
    per lane. `widths` records each level's roles (products side by side)."""

    def __init__(self, src: str):
        self.group = int(re.search(r"#define COMBINE_GROUP (\d+)", src).group(1))
        q = FQ_MODULUS
        self.q, self.ql, self.ninv = q, limbs(q), (-pow(q, -1, 1 << 30)) % (1 << 30)
        self.widths = []
        ns = {"Jpt": Jpt, "fe_role": self.role, "fe_mul": self.mul, "fe_sqr": lambda a: self.mul(a, a),
              "fe_group_from": lambda p, k: p[k], "fe_add": lambda a, b: (a + b) % q,
              "fe_sub": lambda a, b: (a - b) % q, "fe_dbl": lambda a: 2 * a % q,
              "fe_select": lambda c, a, b: a if c else b, "fe_is_zero": lambda a: a == 0}
        for name in ("coop_dbl", "coop_add"):
            exec(_translate(src, name), ns)  # noqa: S102
        self.dbl, self.add = ns["coop_dbl"], ns["coop_add"]

    def role(self, vals):
        assert len(vals) <= self.group
        return ("role", len(vals), [vals[i] if i < len(vals) else vals[0] for i in range(self.group)])

    def _prod(self, a: int, b: int) -> int:
        out, carry, top = fe_mul_model(limbs(a), limbs(b), self.ql, self.ninv)
        assert carry == 0 and top < 1 << 64
        r = sum(v << (30 * k) for k, v in enumerate(out))
        return r - self.q if r >= self.q else r

    def mul(self, a, b):
        width = max(v[1] if isinstance(v, tuple) else 1 for v in (a, b))
        self.widths.append(width)
        if not isinstance(a, tuple) and not isinstance(b, tuple):
            return self._prod(a, b)
        lanes = lambda v: v[2] if isinstance(v, tuple) else [v] * self.group  # noqa: E731
        return [self._prod(x, y) for x, y in zip(lanes(a), lanes(b))]


def _ints(t: torch.Tensor) -> list:
    """(18, lanes) 15-bit limbs -> the ints they hold."""
    a = t.to(torch.int64).tolist()
    return [sum(a[k][j] << (15 * k) for k in range(18)) for j in range(t.shape[1])]


def _tensor(vals: list) -> torch.Tensor:
    return torch.tensor([[(v >> (15 * k)) & 0x7FFF for v in vals] for k in range(18)], dtype=torch.int32)


def _jpts(p: JacobianPoints) -> list:
    return [Jpt(x, y, z, bool(i)) for x, y, z, i in zip(_ints(p.x), _ints(p.y), _ints(p.z), p.inf.tolist())]


def _points(pts: list) -> JacobianPoints:
    return JacobianPoints(_tensor([p.x for p in pts]), _tensor([p.y for p in pts]), _tensor([p.z for p in pts]),
                          torch.tensor([p.inf for p in pts]))


def _jacobian(host: list, rng) -> list:
    """Host points (None = infinity, given live coordinates) at random z, in
    the internal form."""
    q, out = FQ_MODULUS, []
    g = host_curve.G1_GENERATOR
    for h in host:
        px, py = h or host_curve.g1_mul(g, 5)
        z = int.from_bytes(rng.bytes(32), "little") % (q - 1) + 1
        out.append(Jpt(*(v * R_INTERNAL % q for v in (px * z * z, py * z * z * z, z)), inf=h is None))
    return out


@pytest.fixture(scope="module")
def coop():
    return CoopModel(_source())


def test_coop_levels(coop):
    """dbl-2009-l in 3 levels of 3, 3 and 1 products, add-2007-bl in 4 of 5,
    4, 5 and 3, each within the group; a round at c = 13 is 43 product
    latencies (13 x 7 + 16 = 107 one after another on one thread)."""
    p = _jacobian([host_curve.g1_mul(host_curve.G1_GENERATOR, k) for k in (3, 7)], np.random.default_rng(1))
    coop.widths = []
    coop.dbl(p[0].x, p[0].y, p[0].z)
    assert coop.widths == [3, 3, 1]
    coop.widths = []
    coop.add(p[0], p[1])
    assert coop.widths == [5, 4, 5, 3]
    assert max([3, 3, 1, 5, 4, 5, 3]) <= coop.group
    assert 13 * 3 + 4 == 43


ADD_CASES = ("random", "equal", "negation", "p1_infinity", "p2_infinity", "both_infinity")


@pytest.mark.parametrize("case", ADD_CASES)
def test_coop_add_matches_plain(coop, case):
    """coop_add against plain_add (add-2007-bl with the reference's branch
    ladder), limb for limb: P + Q, P + P (the doubling branch), P - P (to
    infinity), either or both operands at infinity with live coordinates;
    and coop_dbl against plain_dbl on the same P."""
    rng = np.random.default_rng(ADD_CASES.index(case) + 7)
    g = host_curve.G1_GENERATOR
    hp, hq = (host_curve.g1_mul(g, int(k)) for k in rng.integers(1, 1 << 30, size=2))
    hq = {"equal": hp, "negation": host_curve.g1_neg(hp)}.get(case, hq)
    p, q = _jacobian([None if case in ("p1_infinity", "both_infinity") else hp,
                      None if case in ("p2_infinity", "both_infinity") else hq], rng)
    got = coop.add(p, q)
    want = _jpts(plain_add(_points([p]), _points([q])))[0]
    assert (got.x, got.y, got.z, got.inf) == (want.x, want.y, want.z, want.inf)
    x, y, z = coop.dbl(p.x, p.y, p.z)
    want = _jpts(plain_dbl(_points([p])))[0]
    assert (x, y, z) == (want.x, want.y, want.z)


def _coop_horner(coop, windows: JacobianPoints, c: int) -> Jpt:
    """window_combine_kernel's loop for one chain on the model."""
    acc = Jpt(0, 0, 0, True)
    for w in reversed(_jpts(windows)):
        for _ in range(c):
            acc.x, acc.y, acc.z = coop.dbl(acc.x, acc.y, acc.z)
        acc = coop.add(acc, w)
    return acc


def test_coop_horner_matches_jax_horner(coop, jax_horner):
    """The model's Horner chain on each edge case against the JAX package's
    Horner loop (the module's fixture: no new compile) and plain_window_combine."""
    jx, jy, jz, jinf = jax_horner
    for i, case in enumerate(CASES):
        windows = _edge_windows(case)[0]
        got = _coop_horner(coop, windows, C)
        want = _jpts(JacobianPoints(*(torch.from_numpy(np.array(t)[..., i : i + 1]) for t in (jx, jy, jz)),
                                    torch.tensor([bool(jinf[i])])))[0]
        assert (got.x, got.y, got.z, got.inf) == (want.x, want.y, want.z, want.inf), case
        plain = _jpts(msm_kernels.plain_window_combine(windows, C))[0]
        assert (got.x, got.y, got.z, got.inf) == (plain.x, plain.y, plain.z, plain.inf), case


@pytest.mark.parametrize("case", CASES)
def test_coop_horner_matches_host_oracle(coop, case):
    windows, host = _edge_windows(case)
    got = _coop_horner(coop, windows, C)
    assert jacobian_to_host(_points([got])) == [_horner_oracle(host)]
