"""``witness_native_pct`` on hand-made proof records: None where the
records lack the counters (an older program) or there are none, 100
where every value took the native pass, and the median share of a
mixed window."""

import pytest

from test_span_metrics import _record, reader, records  # noqa: F401


def _rec(i, native=None, fallback=None):
    rec = _record(i, [("witness.convert", 0, 1)])
    if native is not None:
        rec["counters"].update(witness_native=native,
                               witness_fallback=fallback)
    return rec


@pytest.mark.parametrize("recs, want", [
    ([], None),
    ([_rec(1), _rec(2)], None),                         # no counters
    ([_rec(1, 0, 0), _rec(2, 0, 0)], None),             # nothing uploaded
    ([_rec(1, 9, 0), _rec(2, 9, 0)], 100.0),
    ([_rec(1, 3, 1), _rec(2, 1, 3), _rec(3, 2, 2), _rec(4, 4, 0)], 62.5),
], ids=["no_records", "no_counters", "no_values", "all_native", "mixed"])
def test_witness_native_pct(records, recs, want):  # noqa: F811
    records(recs)
    got = reader("witness_native_pct").read({"proofs": [{}] * len(recs)})
    assert got == (None if want is None else pytest.approx(want))
