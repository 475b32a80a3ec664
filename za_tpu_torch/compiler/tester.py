"""Embedded ``#[test]`` template runner
(reference: compiler/src/tester/embeeded.rs)."""

from __future__ import annotations

from typing import Optional

from ..algebra import FS
from .constraints import Constraints
from .evaluator import Evaluator, Mode, Scope, Template
from .signals import Signals


def run_embedded_tests(
    path: str,
    filename: str,
    debug: bool = False,
    skip_compile: bool = False,
    output_witness: bool = False,
    test_prefix: str = "",
) -> None:
    """Collect #[test] templates, then for each: GenWitness run, optional
    binary witness dump, GenConstraints run, signal-table cross-check,
    and R1CS satisfaction check (embeeded.rs:10-121)."""

    scan = Evaluator(Mode.COLLECT)
    scan_scope = scan.eval_file(path, filename)

    tests = sorted(
        k
        for k, v in scan_scope.vars.items()
        if isinstance(v, Template)
        and "test" in v.attrs
        and k.startswith(test_prefix)
    )

    for test_name in tests:
        print(f"* Testing {test_name}")

        print("  -> Generating witness")
        ev_witness = Evaluator(Mode.GEN_WITNESS)
        ev_witness.debug = debug
        ev_witness.eval_template(scan_scope, test_name)

        if output_witness:
            write_binwitness(f"./{test_name}.binwitness", ev_witness.signals)

        if skip_compile:
            continue

        print("  -> Generating constraints")
        ev_constraints = Evaluator(Mode.GEN_CONSTRAINTS)
        ev_constraints.debug = debug
        ev_constraints.eval_template(scan_scope, test_name)

        # sanity: the two runs must declare the same signal table
        wi_count = len(ev_witness.signals)
        cn_count = len(ev_constraints.signals)
        for n in range(1, min(wi_count, cn_count)):
            wi = ev_witness.signals.get_by_id(n)
            cn = ev_constraints.signals.get_by_id(n)
            if wi.full_name != cn.full_name:
                raise AssertionError(
                    f"constrain & witness signals differ "
                    f"#cn(len={cn_count})={cn.full_name},"
                    f"#wi(len={wi_count})={wi.full_name}"
                )
        if cn_count != wi_count:
            raise AssertionError(
                f"constrain & witness signals differ "
                f"#cn(len={cn_count}),#wi(len={wi_count})"
            )

        print(
            f"  -> Testing {len(ev_constraints.constraints)} constraints "
            "evals to zero"
        )
        ev_constraints.constraints.satisfies_with_signals(ev_witness.signals)


def write_binwitness(path: str, signals: Signals) -> None:
    """Binary witness: count, 1, then signal values in write_256_w32 word
    order (embeeded.rs:47-57)."""
    with open(path, "wb") as f:
        f.write(FS(len(signals)).write_256_w32())
        f.write(FS(1).write_256_w32())
        for n in range(1, len(signals)):
            sig = signals.get_by_id(n)
            f.write(sig.value.v.write_256_w32())


def render_span(src: str, start: int, end: int, file: str,
                label: str = "", context: int = 1) -> str:
    """codespan-style labeled source span (reference renders spans with
    codespan-reporting, tester/report.rs:28-57): gutter with line
    numbers, the byte span underlined with carets, a label on the
    underline, +-`context` surrounding lines."""
    end = max(end, start + 1)
    lines = src.split("\n")
    # line/column (0-based) of a byte offset
    starts = []
    off = 0
    for ln in lines:
        starts.append(off)
        off += len(ln) + 1
    import bisect

    l0 = bisect.bisect_right(starts, start) - 1
    l1 = bisect.bisect_right(starts, min(end - 1, len(src))) - 1
    c0 = start - starts[l0]
    width = len(str(min(l1 + context, len(lines) - 1) + 1))
    gut = " " * width
    out = [f"{gut}┌─ {file}:{l0 + 1}:{c0 + 1}", f"{gut}│"]
    lo = max(0, l0 - context)
    hi = min(len(lines), l1 + 1 + context)
    for i in range(lo, hi):
        out.append(f"{i + 1:>{width}} │ {lines[i]}")
        if l0 <= i <= l1:
            a = start - starts[i] if i == l0 else 0
            b = (min(end - starts[i], len(lines[i]))
                 if i == l1 else len(lines[i]))
            carets = " " * a + "^" * max(b - a, 1)
            tag = f" {label}" if label and i == l1 else ""
            out.append(f"{gut} │ {carets}{tag}")
    out.append(f"{gut}│")
    return "\n".join(out)


def dump_error(eval: Evaluator, err: str) -> None:
    """Render the captured error context with a labeled source span
    (reference: tester/report.rs codespan rendering)."""
    print(f"❌ error: {err}")
    ctx = eval.last_error
    if ctx is None:
        return
    try:
        with open(ctx.file) as f:
            src = f.read()
        print(render_span(src, ctx.meta.start, ctx.meta.end, ctx.file,
                          label="failure here"))
    except OSError:
        print(f"  file: {ctx.file}")
        print(f"  at offset {ctx.meta.start}..{ctx.meta.end}")
        print(ctx.scope)
    print(f"  = component: {ctx.component}")
    if ctx.function:
        print(f"  = function: {ctx.function}")
