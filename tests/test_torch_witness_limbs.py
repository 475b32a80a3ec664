"""The witness upload (``GpuEngine.witness_limbs_dev`` over
``field.witness_rows``, ``native/witness_limbs.c``, and
``field.rows_to_limbs``): the (16, nv) int32 limbs it gives equal
``field.ints_to_limbs([v % R for v in z])`` bit for bit, for exact ints
in and out of range, values that take the native pass's Python fallback,
and every sequence type; where that expression raises, the upload raises
the same.  The proof record counts the values each way, and without the
native library the Python path gives the same tensor.  On a card
(``cuda``): the pinned copy equals the Python path at 2^20, and two
witnesses uploaded back to back through the one pinned buffer, the first
copy held up behind a sleep kernel, both arrive whole."""

import random

import numpy as np
import pytest
import torch

import za_tpu_torch.engine.engine as engine_mod
from za_tpu_torch.curve import R
from za_tpu_torch.engine import field as F, metrics
from za_tpu_torch.native import witness_lib

EDGES = [0, 1, R - 1, R, R + 1, 2**256 - 1, 2**256, -1, -R, 2**1000 + 7]


def _random(n, seed=23):
    rng = random.Random(seed)
    return [rng.randrange(1 << 256) for _ in range(n)]


CASES = {
    "random_2^16": lambda: _random(1 << 16),
    **{f"edge_{i}": (lambda v=v: [v]) for i, v in enumerate(EDGES)},
    "edges": lambda: list(EDGES),
    "bool": lambda: [True, False, 5],
    "int64": lambda: [np.int64(5)],
    "uint64_above_2^63": lambda: [np.uint64(2**63 + 5)],
    "tuple": lambda: tuple(EDGES[:7]),
    "list": lambda: _random(1000, seed=5) + EDGES[:7],
    "empty": lambda: [],
    "range": lambda: range(R - 3, R + 3),
}


def _expected(z):
    """-> (the (16, nv) int32 limbs, None) or (None, the exception type)
    of the Python conversion."""
    try:
        limbs = F.ints_to_limbs([v % R for v in z])
    except (OverflowError, TypeError, ValueError) as exc:
        return None, type(exc)
    return torch.from_numpy(limbs.astype(np.int32)), None


@pytest.fixture(autouse=True)
def _native():
    assert witness_lib() is not None, "the native witness pass did not build"


@pytest.mark.parametrize("case", list(CASES))
def test_native_rows_widen_to_the_python_limbs(case):
    z = CASES[case]()
    want, raises = _expected(z)
    eng = engine_mod.GpuEngine(device="cpu")
    if raises is not None:
        with pytest.raises(raises):
            eng.witness_limbs_dev(z)
        return
    got = eng.witness_limbs_dev(z)
    assert got.dtype == torch.int32 and got.shape == (F.NLIMBS, len(z))
    assert torch.equal(got, want)
    # the rows alone: z mod R, eight little-endian 32-bit limbs a row
    if isinstance(z, (list, tuple)):
        rows = torch.empty((len(z), F.NL32), dtype=torch.int32)
        F.witness_rows(z, rows)
        assert [int.from_bytes(r.numpy().tobytes(), "little")
                for r in rows] == [int(v % R) for v in z]


def test_rows_are_validated_before_the_native_pass():
    z = [1, 2, 3]
    for rows in (torch.empty((2, 8), dtype=torch.int32),
                 torch.empty((3, 8), dtype=torch.int64),
                 torch.empty((8, 3), dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            F.witness_rows(z, rows)
    with pytest.raises(TypeError):      # the native pass's own check
        F.witness_rows(np.arange(3), torch.empty((3, 8), dtype=torch.int32))


def test_the_record_counts_native_and_fallback_values(monkeypatch):
    monkeypatch.setattr(metrics.StageTimer, "enabled", True)
    z = [3, R + 2, -1, True, 2**300, 7, 0, 2**256 - 1]   # 3 fall back
    eng = engine_mod.GpuEngine(device="cpu")
    with metrics.ProofSpan():
        eng.witness_limbs_dev(z)
        eng.witness_limbs_dev(z)        # the same object: no second upload
    c = metrics.recent()[-1]["counters"]
    assert (c["witness_native"], c["witness_fallback"]) == (5, 3)
    # one copy of 32 B a value that the host does not wait for
    assert (c["h2d_copies"], c["h2d_bytes"], c["syncs"]) == (1, 32 * 8, 0)


def test_without_the_library_the_python_path_gives_the_same(monkeypatch):
    monkeypatch.setattr(metrics.StageTimer, "enabled", True)
    z = _random(4096, seed=9) + EDGES[:7]
    native = engine_mod.GpuEngine(device="cpu").witness_limbs_dev(list(z))
    monkeypatch.setattr(engine_mod, "witness_lib", lambda: None)
    with metrics.ProofSpan():
        plain = engine_mod.GpuEngine(device="cpu").witness_limbs_dev(z)
    assert torch.equal(native, plain)
    assert torch.equal(plain, _expected(z)[0])
    c = metrics.recent()[-1]["counters"]
    assert (c["witness_native"], c["witness_fallback"]) == (0, len(z))
    assert (c["h2d_bytes"], c["syncs"]) == (64 * len(z), 1)


@pytest.mark.cuda
def test_pinned_upload_equals_the_python_path_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    z1, z2 = _random(1 << 20, seed=1), _random(1 << 20, seed=2)
    eng = engine_mod.GpuEngine()
    with monkeypatch.context() as mp:
        mp.setattr(engine_mod, "witness_lib", lambda: None)
        plain1 = engine_mod.GpuEngine().witness_limbs_dev(list(z1))
        plain2 = engine_mod.GpuEngine().witness_limbs_dev(list(z2))
    first = eng.witness_limbs_dev(list(z1))
    assert eng._rows.is_pinned()
    assert torch.equal(first, plain1)
    # the next witness's rows go into the same buffer while the first
    # copy still waits behind ~0.5 s of sleep: the event wait holds them
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)
    a = eng.witness_limbs_dev(list(z1))
    buf = eng._rows
    assert not eng._rows_copied.query()
    b = eng.witness_limbs_dev(list(z2))
    assert eng._rows is buf
    torch.cuda.synchronize()
    assert torch.equal(a, plain1) and torch.equal(b, plain2)
