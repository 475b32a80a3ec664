"""Constraint reduction (reference: compiler/src/optimizer/mod.rs).

Three rewrite rules:
  1. rows whose a or b is a single ``c*ONE`` term fold into pure-C rows;
  2. pure-C 2-term rows ``c1*S1 + c2*S2 = 0`` eliminate one signal by the
     substitution ``S := -(c2/c1)*S'`` (never touching irreducible
     signals, i.e. main component I/O);
  3. the substitution graph is transitively compressed to fixpoint.

Returns (optimized constraints, sorted list of removed signal ids); the
removed ids become ``ignore_signals`` in the proving key.
"""

from __future__ import annotations

import logging

from ..algebra import FS, LC, QEQ, SIGNAL_ONE, SignalId
from .constraints import Constraints


log = logging.getLogger("za_tpu_torch")


def optimize(
    constraints: Constraints, irreducible_signals: list[SignalId]
) -> tuple[Constraints, list[SignalId]]:
    constraints, removed = optimize_n(constraints, irreducible_signals)
    log.info("optimize: %d constraints, %d signals removed",
             len(constraints), len(removed))
    return constraints, removed


def optimize_n(
    constraints: Constraints, irreducible_signals: list[SignalId]
) -> tuple[Constraints, list[SignalId]]:
    irreducible = set(irreducible_signals)
    replaces: dict[SignalId, tuple[SignalId, FS]] = {}
    rmconstraints: list[int] = []

    for n_c in range(len(constraints)):
        cnstr = constraints.get(n_c)

        # rule 1: [c1*ONE]*[b]+[c] :> [][]+[c1*b + c]  (mod.rs:43-57)
        if len(cnstr.a.t) == 1 and cnstr.a.t[0][0] == SIGNAL_ONE:
            cnstr = QEQ(
                LC.zero(), LC.zero(), cnstr.c.add_lc(cnstr.b.mul_fs(cnstr.a.t[0][1]))
            )
        elif len(cnstr.b.t) == 1 and cnstr.b.t[0][0] == SIGNAL_ONE:
            cnstr = QEQ(
                LC.zero(), LC.zero(), cnstr.c.add_lc(cnstr.a.mul_fs(cnstr.b.t[0][1]))
            )

        # rule 2: [][]+[c1S1+c2S2] eliminates a signal (mod.rs:63-103)
        if not cnstr.a.t and not cnstr.b.t and len(cnstr.c.t) == 2:
            first, second = cnstr.c.t[0], cnstr.c.t[1]
            f_irr = first[0] in irreducible
            s_irr = second[0] in irreducible
            if not f_irr and s_irr:
                search, replace = first, second
            elif f_irr and not s_irr:
                search, replace = second, first
            elif not f_irr and not s_irr:
                if first[0] > second[0]:
                    search, replace = first, second
                else:
                    search, replace = second, first
            else:
                continue

            search_s = search[0]
            replace_s = replace[0]
            replace_f = -(replace[1].div(search[1]))

            if search_s not in replaces:
                while replace_s in replaces:
                    r_s, r_f = replaces[replace_s]
                    replace_s = r_s
                    replace_f = replace_f * r_f
                replaces[search_s] = (replace_s, replace_f)
                rmconstraints.append(n_c)

    # rule 3: compress the substitution graph to fixpoint (mod.rs:120-144)
    any_processed = True
    while any_processed:
        any_processed = False
        for s in list(replaces.keys()):
            r_s, r_f = replaces[s]
            if r_s in replaces:
                r2_s, r2_f = replaces[r_s]
                replaces[s] = (r2_s, r_f * r2_f)
                any_processed = True

    # rewrite surviving rows
    opt = Constraints()
    rmset = set(rmconstraints)

    def rewrite(lc: LC) -> LC:
        out = []
        for s, c in lc.t:
            if s in replaces:
                r_s, r_f = replaces[s]
                out.append((r_s, c * r_f))
            else:
                out.append((s, c))
        return LC(out)

    for n_c in range(len(constraints)):
        if n_c in rmset:
            continue
        con = constraints.get(n_c)
        opt.push(QEQ(rewrite(con.a), rewrite(con.b), rewrite(con.c)), None)

    removed = sorted(replaces.keys())
    return opt, removed
