"""The port's circuit frontend, witness programs and pk format against
za_tpu's, with zero tolerance: values mod r, bytes and strings.

za_tpu's own frontend and format tests (algebra, parser, evaluator,
optimizer, embedded tests, the bincode and Parameters golden bytes,
checked deserialization, witness traces) run as cases of one test with
every ``za_tpu`` import pointed at the port.  The rest compiles the
same circuits in both packages (signals, constraints, optimizer output,
``za test``), writes one pk in both (identical bytes, each package
reading the other's, raw and checked), and replays one witness program
across both."""

import ast
import importlib
import io
import os
import random
import re
import types

import pytest

from za_tpu.curve import (
    G1_GEN as ZG1, G2_GEN as ZG2, g1_mul as z_g1_mul, g2_mul as z_g2_mul,
)
import za_tpu_torch.curve as TC

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
PKGS = ("za_tpu", "za_tpu_torch")

# -- za_tpu's frontend tests through the port -------------------------------------

REF_TEST_FILES = ("test_algebra", "test_parser", "test_evaluator",
                  "test_optimizer", "test_tester", "test_bincode_golden",
                  "test_format_checked", "test_wtrace")


def _ref_cases():
    """(file, test) for every undecorated test function of the files
    (the decorated ones skip without circomlib's fixtures)."""
    out = []
    for name in REF_TEST_FILES:
        with open(os.path.join(TESTS, name + ".py")) as f:
            tree = ast.parse(f.read())
        out += [(name, node.name) for node in tree.body
                if isinstance(node, ast.FunctionDef)
                and node.name.startswith("test_") and not node.decorator_list]
    return out


_PORTED: dict = {}


def _ported(name: str) -> types.ModuleType:
    """tests/<name>.py with every za_tpu import (and the logger name)
    pointed at za_tpu_torch, as a module of its own."""
    if name not in _PORTED:
        path = os.path.join(TESTS, name + ".py")
        with open(path) as f:
            src = re.sub(r"\bza_tpu\b", "za_tpu_torch", f.read())
        assert "import jax" not in src
        mod = types.ModuleType(f"ported_{name}")
        mod.__file__ = path
        exec(compile(src, path, "exec"), mod.__dict__)
        _PORTED[name] = mod
    return _PORTED[name]


@pytest.mark.parametrize("case", [f"{f}::{t}" for f, t in _ref_cases()])
def test_reference_frontend_tests_pass_on_the_port(case, request):
    name, fn_name = case.split("::")
    fn = getattr(_ported(name), fn_name)
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fn(*(request.getfixturevalue(a) for a in args))


def test_reference_cases_cover_the_files():
    cases = _ref_cases()
    assert len(cases) >= 100
    assert {f for f, _ in cases} == set(REF_TEST_FILES)


# -- compile parity ---------------------------------------------------------------

CHAIN = (
    "template chain(N) {\n"
    " signal input x;\n signal output out;\n signal t[N];\n"
    " t[0] <== x * x;\n"
    " for (var i=1;i<N;i+=1) { t[i] <== t[i-1] * t[i-1] + i; }\n"
    " out <== t[N-1];\n}\ncomponent main = chain(%d);\n"
)

SUBTEMPLATE = """
function square(v) { return v * v; }

template Inner(k) {
    signal input a;
    signal private input b;
    signal output c;
    signal d;
    d <== a * b;
    c <== d * k + square(3);
}

template Outer() {
    signal input x;
    signal private input y;
    signal output z;
    component p = Inner(5);
    component q = Inner(7);
    p.a <== x;
    p.b <== y;
    q.a <== p.c;
    q.b <== y;
    z <== q.c;
}

#[test]
template test_outer() {
    component main = Outer();
    main.x <== 2;
    main.y <== 3;
    main.z === ((2 * 3 * 5 + 9) * 3) * 7 + 9;
}

#[test]
template test_inner() {
    component main = Inner(2);
    main.a <== 4;
    main.b <== 6;
    main.c === 57;
}

component main = Outer();
"""


def _circuit(which: str) -> str:
    if which == "example":
        with open(os.path.join(ROOT, "example", "circuit.za")) as f:
            return f.read()
    if which == "chain64":
        return CHAIN % 64
    return SUBTEMPLATE


def _mods(pkg: str) -> types.SimpleNamespace:
    imp = importlib.import_module
    return types.SimpleNamespace(
        compiler=imp(f"{pkg}.compiler"), tester=imp(f"{pkg}.compiler.tester"),
        bincode=imp(f"{pkg}.groth16.bincode"), fmt=imp(f"{pkg}.groth16.format"),
        r1cs=imp(f"{pkg}.groth16.r1cs"), wtrace=imp(f"{pkg}.compiler.wtrace"),
        algebra=imp(f"{pkg}.algebra"), __name__=pkg)


def _compile(pkg: str, tmp_path, text: str) -> dict:
    """Compile with one package -> everything it produced, as plain
    values and bytes."""
    m = _mods(pkg)
    (tmp_path / "circuit.za").write_text(text)
    ev = m.compiler.Evaluator(m.compiler.Mode.GEN_CONSTRAINTS)
    ev.eval_file(str(tmp_path), "circuit.za")
    sig = ev.signals
    cons = ev.constraints

    def rows(c):
        return [m.bincode.serialize_qeq(c.get(i)) for i in range(len(c))]

    opt, removed = m.compiler.optimize(cons, sig.main_input_ids())
    r1cs = m.r1cs.R1CS.from_constraints(sig, opt, removed)
    return {
        "signals": [(n, s.full_name, int(s.xtype), sig.to_string(n))
                    for n in range(len(sig)) for s in [sig.get_by_id(n)]],
        "public": sig.main_public_input_names(),
        "constraints": rows(cons),
        "constraint_text": [sig.format(m.algebra.Value(cons.get(i)))
                            for i in range(len(cons))],
        "optimized": rows(opt),
        "removed": list(removed),
        "asts": m.bincode.serialize_asts(ev.collected_asts),
        "r1cs": (r1cs.num_inputs, r1cs.num_aux, r1cs.input_names,
                 r1cs.a_rows, r1cs.b_rows, r1cs.c_rows, r1cs.var_of_signal,
                 r1cs.densities()),
    }


def _za_test(pkg: str, tmp_path, capsys) -> str:
    try:
        _mods(pkg).tester.run_embedded_tests(str(tmp_path), "circuit.za")
        result = "passed"
    except Exception as exc:  # noqa: BLE001 -- compared across packages
        result = f"failed: {exc!r}"
    return capsys.readouterr().out + result


@pytest.mark.parametrize("which", ["example", "chain64", "subtemplate"])
def test_compile_parity(which, tmp_path, capsys):
    text = _circuit(which)
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = _compile(pkg, d, text)
        got[pkg]["za_test"] = _za_test(pkg, d, capsys)
    ref, port = got["za_tpu"], got["za_tpu_torch"]
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k] == ref[k], k
    if which == "subtemplate":
        assert "* Testing test_inner" in port["za_test"]
        assert port["za_test"].endswith("passed")
        assert len(port["optimized"]) < len(port["constraints"])


def test_za_test_failure_parity(tmp_path, capsys):
    text = SUBTEMPLATE.replace("main.c === 57;", "main.c === 58;")
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        (d / "circuit.za").write_text(text)
        out[pkg] = _za_test(pkg, d, capsys)
    assert "failed" in out["za_tpu"]
    assert out["za_tpu_torch"] == out["za_tpu"]


# -- the curve's scalar multiplication ----------------------------------------------


def test_scalar_mul_matches_reference():
    """The port's Jacobian-coordinate g1_mul / g2_mul against za_tpu's
    affine double-and-add: edge scalars, random ones, r (infinity on the
    subgroup) and the subgroup check."""
    rng = random.Random(7)
    ks = [0, 1, 2, 3, 4, TC.R - 1, TC.R, TC.R + 5] + [
        rng.randrange(TC.R) for _ in range(12)]
    p1 = z_g1_mul(ZG1, 12345)
    p2 = z_g2_mul(ZG2, 999)
    t2 = (TC.Fq2(p2[0].c0, p2[0].c1), TC.Fq2(p2[1].c0, p2[1].c1))

    def g2(p):
        return None if p is None else (p[0].c0, p[0].c1, p[1].c0, p[1].c1)

    for k in ks:
        assert TC.g1_mul(p1, k) == z_g1_mul(p1, k), k
        assert g2(TC.g2_mul(t2, k)) == g2(z_g2_mul(p2, k)), k
    assert TC.g1_mul(None, 5) is None and TC.g2_mul(None, 5) is None
    assert TC.g2_mul(t2, TC.R) is None and TC.g2_is_in_subgroup(t2)


# -- one pk written and read by both packages -----------------------------------------

TOXIC = dict(tau=11, alpha=3, beta=5, gamma=7, delta=9)


def _params_key(params, raw: bool):
    """Parameters -> plain values (query vectors of raw reads as their
    limb arrays, of point reads as int tuples)."""

    def pt(p):
        if p is None or isinstance(p[0], int):
            return p
        return (p[0].c0, p[0].c1, p[1].c0, p[1].c1)

    vk = params.vk
    head = tuple(pt(p) for p in (vk.alpha_g1, vk.beta_g1, vk.beta_g2,
                                  vk.gamma_g2, vk.delta_g1, vk.delta_g2))
    head += (tuple(pt(p) for p in vk.ic), params.domain_size)
    qs = []
    for name in ("h", "l", "a", "b_g1", "b_g2"):
        q = getattr(params, name)
        if raw:
            keys = ("x0", "x1", "y0", "y1", "z0") if name == "b_g2" \
                else ("x", "y", "z")
            qs.append(tuple(getattr(q, k).tolist() for k in keys))
        else:
            qs.append(tuple(pt(p) for p in q))
    return head, tuple(qs)


@pytest.fixture(scope="module")
def chain_pk(tmp_path_factory):
    """The chain at N = 64 compiled by each package, one set of params
    (the port's setup, fixed toxic waste), and each package's pk bytes."""
    from za_tpu_torch.groth16.setup import generate_parameters

    tmp = tmp_path_factory.mktemp("pk")
    out = {}
    for pkg in PKGS:
        m = _mods(pkg)
        ev = m.compiler.Evaluator(m.compiler.Mode.GEN_CONSTRAINTS)
        (tmp / "circuit.za").write_text(CHAIN % 64)
        ev.eval_file(str(tmp), "circuit.za")
        cons, removed = m.compiler.optimize(ev.constraints,
                                            ev.signals.main_input_ids())
        r1cs = m.r1cs.R1CS.from_constraints(ev.signals, cons, removed)
        out[pkg] = {"m": m, "asts": ev.collected_asts, "cons": cons,
                    "removed": removed, "r1cs": r1cs}
    params = generate_parameters(out["za_tpu_torch"]["r1cs"], **TOXIC)
    for pkg, d in out.items():
        f = io.BytesIO()
        d["m"].fmt.write_pk(f, d["asts"], d["cons"], d["removed"], params,
                            densities=d["r1cs"].densities())
        d["bytes"] = f.getvalue()
    out["params"] = params
    return out


def _read(reader, data: bytes, raw: bool):
    m = reader["m"]
    pk = m.fmt.read_pk(io.BytesIO(data), raw_queries=raw)
    return (m.bincode.serialize_asts(pk.asts),
            [m.bincode.serialize_qeq(pk.constraints.get(i))
             for i in range(len(pk.constraints))],
            pk.ignore_signals, _params_key(pk.params, raw))


def test_pk_bytes_identical_and_cross_read(chain_pk):
    """Both writers write the same bytes; each package reads the
    other's pk, raw and checked, to what za_tpu reads from its own."""
    from za_tpu_torch.groth16.setup import expand_queries

    ref, port = chain_pk["za_tpu"], chain_pk["za_tpu_torch"]
    assert port["bytes"] == ref["bytes"]
    for raw in (False, True):
        want = _read(ref, ref["bytes"], raw)
        assert want[0] == ref["m"].bincode.serialize_asts(ref["asts"])
        for writer in (ref, port):
            assert _read(port, writer["bytes"], raw) == want
            assert _read(ref, writer["bytes"], raw) == want
    # the point read, density filtering undone, gives the setup's params
    pk = port["m"].fmt.read_pk(io.BytesIO(ref["bytes"]))
    assert _params_key(expand_queries(pk.params, port["r1cs"]), False) == \
        _params_key(expand_queries(chain_pk["params"], port["r1cs"]), False)


# -- witness: interpreter, trace and replay across the packages ------------------------


def _witness(pkg: str, text: str, x: int):
    m = _mods(pkg)
    ev = m.compiler.Evaluator(m.compiler.Mode.GEN_WITNESS)
    ev.wtrace = m.wtrace.TraceRecorder()
    ev.set_deferred_value("main.x", m.algebra.Value(m.algebra.FS(x)))
    ev.eval_inline(m.compiler.evaluator.Scope(True, None, "root"), text)
    return ev


def test_witness_and_trace_across_packages(tmp_path, monkeypatch):
    """The chain at N = 256: the port's interpreter gives za_tpu's
    signal values; each package's trace file replays in the other
    (native C tape and Python tape) to the same z, keyed on the digest."""
    text = CHAIN % 256
    gen = {}
    for pkg in PKGS:
        m = _mods(pkg)
        cev = m.compiler.Evaluator(m.compiler.Mode.GEN_CONSTRAINTS)
        cev.eval_inline(m.compiler.evaluator.Scope(True, None, "root"), text)
        cons, removed = m.compiler.optimize(cev.constraints,
                                            cev.signals.main_input_ids())
        ev = _witness(pkg, text, 3)
        prog = ev.wtrace.finish(ev.signals)
        path = tmp_path / f"{pkg}.wtrace"
        prog.dump(str(path), b"\x01" * 32)
        r1cs = m.r1cs.R1CS.from_constraints(ev.signals, cons, removed)
        gen[pkg] = {
            "m": m, "cons": cons, "removed": removed, "path": str(path),
            "values": [ev.signals.get_by_id(n).value.v.v
                       for n in range(1, len(ev.signals))],
            "z": r1cs.assignment_from_signals(ev.signals),
        }
    ref, port = gen["za_tpu"], gen["za_tpu_torch"]
    assert port["values"] == ref["values"]
    assert port["z"] == ref["z"]
    with open(ref["path"], "rb") as a, open(port["path"], "rb") as b:
        assert a.read() == b.read()
    from za_tpu_torch.groth16.helper import _z_ints
    from za_tpu_torch.native import wtrace_lib

    assert wtrace_lib() is not None, "the native replay did not build"
    for reader in (ref, port):
        for writer in (ref, port):
            m = reader["m"]
            assert m.wtrace.WitnessProgram.load(writer["path"],
                                                b"\x02" * 32) is None
            prog = m.wtrace.WitnessProgram.load(writer["path"], b"\x01" * 32)
            r1cs = m.r1cs.R1CS.from_constraints(
                prog.meta_signals(), reader["cons"], reader["removed"])
            for x in (3, 10):
                zl, head = prog.run_z({"main.x": x}, r1cs)
                got = _z_ints(zl)
                assert got[:r1cs.num_inputs] == head
                if x == 3:
                    assert got == ref["z"]
                with monkeypatch.context() as mp:   # the Python tape
                    mp.setattr(importlib.import_module(
                        f"{m.__name__}.native"), "wtrace_lib", lambda: None)
                    assert prog.replay_limbs({"main.x": x}) is None
                    py = prog.run_z({"main.x": x}, r1cs)
                assert _z_ints(py[0]) == got and py[1] == head
