#!/usr/bin/env python3
"""Prove Groth16 on one CUDA card through the port (za_tpu_torch) and
check every kernel and every result.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases:
  1. identify the card, build the kernels from za_tpu_torch/csrc (nvcc);
  2. the tree path at full width: the 2^17-constraint multiplier chain
     of bench.py, pk queries from prime-size pools of points with known
     discrete logs, driven through GpuEngine.stage_params and
     groth16.prove; every kernel launch counted; the proof, each of the
     five MSMs and h(x) checked exactly on the host; stage times (CUDA
     events, one warm-up, median of 3) printed as one JSON line, with
     the staging's curve checks of the raw queries run again apart on
     the same coordinates and timed ("curve_check_s"), and the same pk
     staged anew with the check on and off in turns
     ("stage_check_on_off_s"); h(x) runs as kernels (the matvec, the
     four-step NTT with the prefix's load and store modes), checked to
     call no torch field product ("h_torch_ops"), split step by step
     (matvec, iNTT, coset NTT, coset iNTT; one 3-leg transform into
     prefix, tail stages, twiddle transpose), the plain matvec timed
     leg by leg; each MSM split step by step (digits, level 0, levels,
     carry, lane fold, Horner), each step timed alone ("breakdown_s")
     and with CUDA events back to back inside the MSM, one sync
     ("msm_inline_s"), medians of 3; each MSM run once more with its
     aten ops and kernel launches logged: past its first tree level or
     window sums, nothing but allocations, views and its carries, fold
     and Horner ("msm_tail_torch_ops"); launches of the first prove alone
     ("launches_per_proof", staging excluded): a lane fold per MSM, a
     carry per tree MSM, no elementwise ec_add; the engine's stage
     timer (engine/metrics.py, off in this process but here): a prove
     with it off makes no CUDA event, with it on gives the same proof,
     and one run of the device compute with it on logs msm.* and h.*
     stages whose device seconds sum within 10% of that run's device
     compute ("stage_timer");
  3. the dense path at full width: the same at 2^13 constraints, where
     the padded queries stay below TREE_MIN and the four G1 MSMs run as
     one stacked dense MSM; then the same prove through
     GpuEngine(msm_style="fused") (radix 4), checked against the same
     proof, and its MSMs checked and timed; one JSON line;
  4. a real 510-constraint proof: the setup with fixed toxic waste on
     the host and on the card (GpuEngine's fixed-base kernels; equal
     Parameters bytes, its launches a path, "setup510"), then a GpuEngine
     prove from the card's parameters (dense path, the four-step NTT at
     32 x 16) that the pairing check accepts; its launches count as a
     path; then the
     2^13 pk with one raw G1 point off the curve, and with one raw G2
     point off the twist: staging must raise FormatError for each
     (the 2^13 line's "off_curve_refused");
  4b. the tree path at 2^20 constraints, lean: the chain's inputs
     ("inputs_s"), the domain's tables (2^21, "domain_tables_s"), one
     staging ("stage_s"; 2^14-point chunks, each MSM's (S, C) in
     "layout"), the first prove with its launches
     ("launches_per_proof_2^20": a tail launch a sub-NTT of h(x)'s
     three transforms, 6) checked exactly and by the pairing check,
     device compute per stage (median of 3 after a warm-up), h(x) by
     kernel in place ("h_inline_ms": matvec, prefix, tail, twiddle),
     each MSM's launches in place ("msm_inline_ms": carry, fold,
     Horner, the first and the last chunk's levels), "h_torch_ops" all
     zero, peak memory, the phase's seconds; one JSON line;
  4c. the user's path, the za CLI and a prove from a pk file: (a)
     ``python3 -m za_tpu_torch.cli`` setup (the card, by default; random
     toxic waste), prove twice on the card and verify, then setup
     --engine host, a prove from that pk and its verify, each a process
     of its own, on bench.py's chain as circuit text at 600 constraints
     (past the staged gate); (b) the chain's text at 2^17 constraints compiled by
     the port's Evaluator and optimizer, its pk (pool queries, the vk
     solved from their logs) written by format.write_pk, then
     helper.prove three times: interpreting and staging (writing
     <pk>.wtrace and <pk>.gpucache), replaying natively and loading the
     cache, and again in a process of its own; three equal proofs,
     exact against the host's values; pk read, compile, witness,
     staging against the cache load, prove, self-verify and wall
     seconds, peak memory, and what a process pays outside
     helper.prove (imports, CUDA context) at both sizes; one JSON line;
     the CLI's -v prove logs stage lines with device seconds; (c) the
     port's bindings on the card: libza2c built by its Makefile with
     this machine's g++ and python3-config, setup -> prove -> verify
     through the C ABI (test_za2c, a process of its own) and the
     Python binding at the round trip's 600 constraints (dense), and a
     prove from the 2^17 pk (tree, the tables from <pk>.gpucache), each
     proof verified by helper.verify and refused with a public input
     changed (rc 2 through the C ABI), the GpuEngine's stage_info
     read; (d) the own-process prove under ZA_METRICS=1, and a fourth
     in a process of its own that stages (ZA_DEVCACHE=0): their stage
     lines, one JSON line "stage_metrics_131072c";
  4d. the trusted setup on the card at 2^17 constraints (4c's compiled
     chain, fixed toxic waste): generate_parameters with GpuEngine(),
     its launches a path ("setup_2^17"), timed step by step (the QAP's
     values at tau, the scalars, each fixed-base batch: table, upload,
     device, host points); every query held exactly by a random linear
     combination (the port's msm_g1 / msm_g2 against the scalars
     recomputed on the host), the vk by host scalar multiplication; the
     pk written, a proof from it through helper.prove on the card,
     exact against the host's A, B, C and accepted by the pairing check;
     the host setup extrapolated from 1,024 scalar multiplications a
     group; the h query of 2^20 constraints (2^21 - 1 scalars) through
     fixed_base_g1 for its peak memory; one JSON line;
  4e. several ranks (engine/mesh.py over torch.distributed): the 2^17
     chain (tree) proved by 4 ranks and the 2^13 chain (dense) by 2,
     spawned processes sharing the one card over gloo (each collective
     through the host), and the 2^17 chain by a one-rank NCCL group (by
     2 ranks over NCCL where the machine has two cards); the inputs
     written once by this process for the ranks; every rank's proof
     equal to the one-card proof of the same inputs and r, s, the
     pairing check, every rank's MSM points equal, each rank's launches
     a path of their own ("mesh4_2^17.rank0", ...: the route's kernels,
     h(x)'s, log2 D ec_add a MSM for the cross-rank reduce) and its h(x)
     free of torch field products; then `za setup --mesh 2` at 510
     constraints, fixed toxic waste, writing the same pk bytes as the
     setup without --mesh, and `za prove --mesh 2` from that pk (2
     ranks over NCCL on two cards; refused on one); per phase and rank the staging, the first
     prove, its collectives (calls, bytes, seconds), the device compute
     and the wall, one JSON line "mesh_phases" with the card's name and
     power limit: shared-card runs, no scaling number;
  5. each kernel against its plain PyTorch version on the shapes of the
     path that runs it, exact equality (integers mod p), timed beside
     its bound; the tree levels at every level of one 2^17 chunk
     ("per_level_ms"); the matvec and the twiddle transpose at each
     rung's shapes (the chain's three legs; 3 x 512 x 512 at 2^17, 3 x
     128 x 128 at 2^13), the NTT prefix in each mode (scale on load,
     combine on load, scale on store); every kernel's registers and
     spill bytes from the build's ptxas logs ("regs", "spill_bytes"),
     every row's launches per 2^17 and per 2^13 proof
     ("launches_per_proof", "launches_per_proof_2^13"), the Horner
     rows' time per complete add of one MSM's chain and the dense
     rows' per add of one lane's chain ("us_per_add"), the dense rows'
     resident warps an SM ("warps_per_sm", the occupancy query) and
     points a thread walks ("adds_a_thread", n / (S L)), at the (L, S)
     the proof takes; the lane fold at every MSM's shape (its plan:
     windows a block, blocks a window, warps, levels one add a thread)
     and the carry at each 2^17 MSM's (C chunks of partials), device
     time with a chain floor (dependent adds x the Horner rows' time
     per add, "chain_floor_ms"); the tail kernel (ntt_stage_fr) at the
     2^20 proof's sub-NTT tails (a) 3 x 1024 x 2048, (b) 3 x 2048 x
     1024, (c) 1 x 2048 x 1024 with the store mode; the setup's c = 8
     tables as their two kernels, the doubling ladder (with the chain
     floor of its 254 doublings and the ratio to it) and the window
     levels, the whole table timed beside the ladder ("table_ms"), and
     fixed-base MSMs at the 2^17 setup's h (2^18 - 1 G1 scalars) and
     b_g2 (2^17 + 2 G2 scalars); printed as one JSON
     line {"kernels": [...]}; then one NTT through the four-step at
     sizes from 2^9 to 2^21, held to the plain versions and up to 2^12
     to the host Domain.ntt, timed (the 2^17 line's "ntt_routes_ms");
  6. the card's name and power limit, then the result line.
Launches are counted per path (each path's staging and first prove;
the setups) and every kernel must launch on at least one path; the
four-step's kernels on every path, the tail kernel on the 2^20 path
alone, the fixed-base kernels on the setup paths alone.

Exits non-zero without a CUDA card, without the package beside it, or
when any phase fails.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

# H100 SXM peaks used for the bounds (NVIDIA data sheet and Hopper
# white paper): HBM3 at 3.35 TB/s; 32-bit integer multiply-adds on the
# INT32 units, 64 per SM per clock, 132 SMs, 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# one 8x32-limb CIOS Montgomery multiplication: 2 * 8^2 word products,
# each a lo and a hi multiply-add
MADS_PER_MUL = 4 * 8 * 8
# Fq multiplications one complete projective add needs (RCB algorithm 7):
# 12 general ones plus two products by 3b.  In G1, 3b = 9 is three
# doublings and an add, no multiplication (curve.cuh mul_b3, in every
# kernel on point_add); in G2 it is a full Fq2 constant.  An Fq2
# multiplication is 3 Fq ones.
ADD_MULS = {False: 12, True: 3 * 14}
# Fq multiplications of the least doubling (RCB algorithm 9, a = 0): 6
# products, 2 squarings and one product by 3b (none in G1, as above);
# a bound counts a doubling at this, whatever add the kernel doubles with
DBL_MULS = {False: 8, True: 3 * 9}
# to_affine (csrc/ec.cu to_affine_wave_kernel): Fq multiplications per
# point with a nonzero Z, G1 5 (the prefix, two in the walk back, X/Z
# and Y/Z), G2 13 (the norm's two squarings, the prefix, two in the walk
# back, two for conj(Z) N^-1, 3 + 3 for X/Z and Y/Z); and one inv_gcd a
# block, the inversion the batch needs: 20 batches of ~92 32x32-bit
# wide products (a Montgomery product's 256 multiply-adds count 128 of
# them) and one Montgomery product, ~16 products' worth.  The blocks'
# product trees are the design's cost of its split, not counted.
AFFINE_MULS = {False: 5, True: 13}
INV_GCD_MULS = 16

# the __global__ function behind each tree, curve, dense, prefix and
# matvec entry point of csrc/tree.cu, csrc/ec.cu, csrc/dense.cu,
# csrc/ntt.cu and csrc/r1cs.cu, as ptxas names it, up to its last
# template argument: tree_level_rolled_kernel<Fq, true, 8, ...>, <Fq,
# false, 8, ...>, <Fq2, true, 4, ...> and <Fq2, false, 4, ...>;
# horner_warp_g1_kernel, horner_warp_g2_kernel; ec_add_kernel <Fq, Ops,
# ...> and <Fq2, OpsEo, ...>; ec_sum_kernel <F, staged add's
# lanes, thread adds compiled in, fold> (the fold <Fq, 6, true, true>,
# or <Fq, 6, false, true> where no level runs thread adds, and <Fq2,
# 16, false, true>; the carry <Fq, 6, true, false> and <Fq2, 8, false,
# false>); to_affine_wave_kernel
# <Fq, Gcd> and <Fq2, Gcd>; dense_sums_kernel <Fq, true, ...>,
# <Fq2, true, ...> (signed radix 16), <Fq, false, ...>, <Fq2, false,
# ...> (radix 4); ntt_prefix_kernel, ntt_twiddle_kernel<true> (vector
# accesses: the proof's shapes), ntt_tail_kernel<stages>;
# r1cs_matvec_kernel; fixed_base_ladder_kernel and
# fixed_base_levels_kernel <Fq>, <Fq2>, fixed_base_msm_kernel <Fq, Ops>,
# <Fq2, OpsEo>
KERNEL_FN = {
    "dense_window_sums_g1":
        "_ZN2za17dense_sums_kernelINS_2FpINS_7QParamsEEELb1E",
    "dense_window_sums_g2": "_ZN2za17dense_sums_kernelINS_3Fq2ELb1E",
    "dense4_window_sums_g1":
        "_ZN2za17dense_sums_kernelINS_2FpINS_7QParamsEEELb0E",
    "dense4_window_sums_g2": "_ZN2za17dense_sums_kernelINS_3Fq2ELb0E",
    "tree_level0_g1":
        "_ZN2za24tree_level_rolled_kernelINS_2FpINS_7QParamsEEELb1ELi8E",
    "tree_level_g1":
        "_ZN2za24tree_level_rolled_kernelINS_2FpINS_7QParamsEEELb0ELi8E",
    "tree_level0_g2": "_ZN2za24tree_level_rolled_kernelINS_3Fq2ELb1ELi4E",
    "tree_level_g2": "_ZN2za24tree_level_rolled_kernelINS_3Fq2ELb0ELi4E",
    "horner_g1": "_ZN2za21horner_warp_g1_kernelE",
    "horner_g2": "_ZN2za21horner_warp_g2_kernelE",
    "ec_add_g1": "_ZN2za13ec_add_kernelINS_2FpINS_7QParamsEEENS_3OpsE",
    "ec_add_g2":
        "_ZN2za13ec_add_kernelINS_3Fq2ENS_12OpsKaratsubaINS_5MulEoEEE",
    "ec_fold_g1":
        "_ZN2za13ec_sum_kernelINS_2FpINS_7QParamsEEELi6ELb1ELb1E",
    "ec_fold_g1.staged":
        "_ZN2za13ec_sum_kernelINS_2FpINS_7QParamsEEELi6ELb0ELb1E",
    "ec_fold_g2": "_ZN2za13ec_sum_kernelINS_3Fq2ELi16ELb0ELb1E",
    "ec_carry_g1":
        "_ZN2za13ec_sum_kernelINS_2FpINS_7QParamsEEELi6ELb1ELb0E",
    "ec_carry_g2": "_ZN2za13ec_sum_kernelINS_3Fq2ELi8ELb0ELb0E",
    "to_affine_g1":
        "_ZN2za21to_affine_wave_kernelINS_2FpINS_7QParamsEEENS_3GcdE",
    "to_affine_g2": "_ZN2za21to_affine_wave_kernelINS_3Fq2ENS_3GcdE",
    "ntt_prefix_fr": "_ZN2za17ntt_prefix_kernelE",
    "ntt_twiddle_fr": "_ZN2za18ntt_twiddle_kernelILb1E",
    "ntt_stage_fr": "_ZN2za15ntt_tail_kernelILi",   # + stages, "E"
    "r1cs_matvec_fr": "_ZN2za18r1cs_matvec_kernelE",
    "fixed_base_ladder_g1":
        "_ZN2za24fixed_base_ladder_kernelINS_2FpINS_7QParamsEEEEE",
    "fixed_base_ladder_g2": "_ZN2za24fixed_base_ladder_kernelINS_3Fq2EEE",
    "fixed_base_levels_g1":
        "_ZN2za24fixed_base_levels_kernelINS_2FpINS_7QParamsEEEEE",
    "fixed_base_levels_g2": "_ZN2za24fixed_base_levels_kernelINS_3Fq2EEE",
    "fixed_base_msm_g1":
        "_ZN2za21fixed_base_msm_kernelINS_2FpINS_7QParamsEEENS_3OpsE",
    "fixed_base_msm_g2": "_ZN2za21fixed_base_msm_kernelINS_3Fq2ENS_12"
                         "OpsKaratsubaINS_5MulEoEEE",
}

SEED = 20261016
LOG2N = 17        # the tree path
LOG2N_DENSE = 13  # the dense path (padded queries below TREE_MIN)
LOG2N_BIG = 20    # bench.py's top rung: 2^14 tree chunks, sub-NTT tails
# NTT sizes at which the four-step is timed: the 510-constraint check's
# domain and up, both rungs' domains, 2^20 and the top rung's 2^21,
# where the tails run
ROUTE_LOG2 = (9, 10, 11, 12, 14, 18, 20, 21)
# sizes checked against the host Domain.ntt, the others against the
# plain versions
ROUTE_HOST_LOG2 = 12


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def chain_r1cs(n: int, seed: int = 99):
    """bench.py's synthetic multiplier chain t[i] = t[i-1]^2 + i, as R1CS."""
    from za_tpu_torch.curve import R
    from za_tpu_torch.groth16.r1cs import R1CS

    rng = random.Random(seed)
    a_rows, b_rows, c_rows = [], [], []
    z = [1, rng.randrange(1, R)]
    for i in range(n):
        prev, cur = i + 1, i + 2
        a_rows.append([(prev, 1)])
        b_rows.append([(prev, 1)])
        c_rows.append([(cur, 1), (0, (-i) % R)])
        z.append((z[prev] * z[prev] + i) % R)
    r1cs = R1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                a_rows=a_rows, b_rows=b_rows, c_rows=c_rows)
    return r1cs, z


class Timer:
    """CUDA-event timing of a region that ends with a host sync."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn):
        t = self.torch
        a, b = t.cuda.Event(enable_timing=True), t.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        t.cuda.synchronize()
        return out, a.elapsed_time(b) / 1e3


class Split:
    """Named steps of one run, each between two CUDA events.  sync: each
    step ends in a host sync (a step alone); else the events are
    recorded back to back and the host syncs once, in times() (a step
    as it runs inside the stage, host gaps included).  times() ->
    {name: seconds}, summed over the steps of one name."""

    def __init__(self, torch, sync: bool):
        self.torch, self.sync, self.marks = torch, sync, []

    def __call__(self, name, fn):
        ev = self.torch.cuda.Event
        a, b = ev(enable_timing=True), ev(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        if self.sync:
            self.torch.cuda.synchronize()
        self.marks.append((name, a, b))
        return out

    def times(self) -> dict:
        self.torch.cuda.synchronize()
        out = {}
        for name, a, b in self.marks:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / 1e3
        return out


STAGE_LINE = re.compile(r"^\[stage\] (\S+): (.*)$")
STAGE_PART = re.compile(r"^(\S+) ([0-9.]+)s(?: device ([0-9.]+)s)?$")


def parse_stage_lines(messages) -> list:
    """The engine's metrics lines -> [{"name", "wall_s", "device_s"}]
    (device_s None on the CPU); a staging call's block totals carry
    "parts": {part: {"wall_s", "device_s"}} in place of the seconds."""
    out = []
    for msg in messages:
        m = STAGE_LINE.match(msg)
        if not m:
            continue
        name, rest = m.groups()
        one = STAGE_PART.match(f"_ {rest}")
        if one:
            out.append({"name": name, "wall_s": float(one.group(2)),
                        "device_s": one.group(3) and float(one.group(3))})
            continue
        parts = {}
        for field in rest.split(", "):
            p = STAGE_PART.match(field)
            assert p, f"stage line: {msg!r}"
            parts[p.group(1)] = {"wall_s": float(p.group(2)),
                                 "device_s": p.group(3) and float(p.group(3))}
        out.append({"name": name, "parts": parts})
    return out


class KeepLines:
    """Attached to the logger za_tpu_torch.metrics at INFO: keeps every
    message in .lines."""

    def __init__(self):
        import logging

        class Keep(logging.Handler):
            def emit(inner, record):
                self.lines.append(record.getMessage())

        self.lines, self.handler = [], Keep()
        self.log = logging.getLogger("za_tpu_torch.metrics")

    def __enter__(self):
        import logging

        self.level = self.log.level
        self.log.setLevel(logging.INFO)
        self.log.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)
        self.log.setLevel(self.level)


def with_stage_timer(fn):
    """fn() with the engine's stage timer on -> (its result, its parsed
    stage lines)."""
    from za_tpu_torch.engine import metrics

    with KeepLines() as keep:
        metrics.StageTimer.enabled = True
        try:
            out = fn()
        finally:
            metrics.StageTimer.enabled = False
    return out, parse_stage_lines(keep.lines)


def metrics_on_off(torch, prove_compute, prove_once, proof, off_s) -> dict:
    """The 2^17 proof with the engine's stage timer off and on: off, one
    prove creates no CUDA event (torch.cuda.Event counted) and gives the
    proof; on, the prove gives the same proof, and the device compute
    (h and the MSMs, each call timed as prove_path times them; one
    warm-up, median of 3) logs msm.* and h.* stages whose device seconds
    sum within 10% of the device compute with the timer off (off_s).
    With the timer on, each call's span also holds the host's time
    between its stages, which the card waits out at each stage's sync
    ("device_compute_on_s")."""
    real = torch.cuda.Event
    made, syncs = [], []
    real_sync = torch.cuda.synchronize

    def counted_event(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    def counted_sync(*args, **kwargs):
        syncs.append(1)
        return real_sync(*args, **kwargs)

    torch.cuda.Event, torch.cuda.synchronize = counted_event, counted_sync
    try:
        off = prove_once()
    finally:
        torch.cuda.Event, torch.cuda.synchronize = real, real_sync
    assert off == proof, "the timer-off proof differs"
    assert not made, f"the timer off made {len(made)} CUDA events"
    on, proof_lines = with_stage_timer(prove_once)
    assert on == proof, "the timer-on proof differs"
    runs = []
    for _ in range(4):      # the first a warm-up
        stages, lines = with_stage_timer(prove_compute)
        dev = {k: 0.0 for k in ("msm", "h")}
        for line in lines:
            head = line["name"].split(".")[0]
            if head in dev:
                assert line["device_s"] is not None, line
                dev[head] += line["device_s"]
        runs.append((dev["msm"] + dev["h"], sum(stages.values()), dev,
                     lines))
    runs = sorted(runs[1:], key=lambda r: r[0])
    total, compute_on, dev, lines = runs[1]
    assert abs(total - off_s) <= 0.1 * off_s, \
        f"stage device seconds {total} against device compute {off_s}"
    names = {line["name"] for line in proof_lines}
    assert any(n.startswith("msm.g1.tree") for n in names) and \
        {"h.ntt.intt", "h.ntt.coset", "h.combine+intt"} <= names, names
    return {"stage_device_s": total, "stage_device_runs_s":
            [r[0] for r in runs], "stage_device_by": dev,
            "device_compute_off_s": off_s, "ratio": total / off_s,
            "device_compute_on_s": compute_on,
            "device_compute_on_runs_s": [r[1] for r in runs],
            "off_events": len(made), "off_syncs": len(syncs),
            "proof_lines": proof_lines, "compute_lines": lines}


# -- phases 2 and 3: the tree and dense paths at full width ----------------------


def pool_query_g1(rng, k: int, pool: int = 67):
    """k G1 points cycling through a prime-size pool with known discrete
    logs -> (raw query, dlogs).  Arrays are built by indexing the pool's
    limbs, not point by point."""
    import numpy as np

    from za_tpu_torch.curve import G1_GEN, R, g1_mul
    from za_tpu_torch.engine import ec
    from za_tpu_torch.groth16.format import RawG1Query

    s = [rng.randrange(1, R) for _ in range(pool)]
    x, y, z = ec.g1_limb_coords([g1_mul(G1_GEN, v) for v in s])
    idx = np.arange(k) % pool
    return RawG1Query(x[:, idx], y[:, idx], z[:, idx]), s


def pool_query_g2(rng, k: int, pool: int = 19):
    import numpy as np

    from za_tpu_torch.curve import G2_GEN, R, g2_mul
    from za_tpu_torch.engine import ec
    from za_tpu_torch.groth16.format import RawG2Query

    s = [rng.randrange(1, R) for _ in range(pool)]
    c = ec.g2_limb_coords([g2_mul(G2_GEN, v) for v in s])
    idx = np.arange(k) % pool
    return RawG2Query(*(a[:, idx] for a in c[:5])), s


def pool_points(rng, k: int, pool: int, g2: bool = False):
    """k points cycling through a prime-size pool with known discrete
    logs, as the point list format.write_pk writes -> (points, dlogs);
    the draws of pool_query_g1 / pool_query_g2."""
    from za_tpu_torch.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul

    s = [rng.randrange(1, R) for _ in range(pool)]
    mul, gen = (g2_mul, G2_GEN) if g2 else (g1_mul, G1_GEN)
    pts = [mul(gen, v) for v in s]
    return [pts[i % pool] for i in range(k)], s


def pooled_dot(scalars, dlogs) -> int:
    """sum_i c_i * s_{i mod P} mod r, grouped by residue class."""
    from za_tpu_torch.curve import R

    P = len(dlogs)
    sums = [0] * P
    for i, c in enumerate(scalars):
        sums[i % P] += c
    return sum(a % R * b for a, b in zip(sums, dlogs)) % R


def launch_counts() -> dict:
    from za_tpu_torch.engine import _build

    return {k.name: k.launches for k in _build.KERNELS.values()}


def median_runs(fn, reps: int = 3):
    """One warm-up, then reps timed runs of fn() -> {stage: seconds};
    returns (medians, totals, warm-up total)."""
    warm = fn()
    runs = [fn() for _ in range(reps)]
    stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return stages, [sum(r.values()) for r in runs], sum(warm.values())


def chain_inputs(log2n: int) -> dict:
    """The chain at 2^log2n constraints, its witness and a pk from
    prime-size pools with known discrete logs: {"r1cs", "z", "domain",
    "params", "dlogs" (per query), "alpha", "beta", "delta", "r", "s",
    "rng" (for the checks)}."""
    from za_tpu_torch.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul
    from za_tpu_torch.groth16.domain import Domain
    from za_tpu_torch.groth16.setup import Groth16Parameters, VerifyingKey

    r1cs, z = chain_r1cs(1 << log2n)
    n, ni, nv = r1cs.num_constraints, r1cs.num_inputs, r1cs.num_vars
    domain = Domain.for_constraints(n + ni)
    m = domain.size
    rng = random.Random(SEED)
    a_q, sa = pool_query_g1(rng, nv)
    b1_q, sb1 = pool_query_g1(rng, nv)
    l_q, sl = pool_query_g1(rng, r1cs.num_aux)
    h_q, sh = pool_query_g1(rng, m - 1)
    b2_q, sb2 = pool_query_g2(rng, nv)
    alpha, beta, delta = (rng.randrange(1, R) for _ in range(3))
    vk = VerifyingKey(
        alpha_g1=g1_mul(G1_GEN, alpha), beta_g1=g1_mul(G1_GEN, beta),
        beta_g2=g2_mul(G2_GEN, beta), gamma_g2=G2_GEN,
        delta_g1=g1_mul(G1_GEN, delta), delta_g2=g2_mul(G2_GEN, delta),
        ic=[G1_GEN] * ni,
    )
    params = Groth16Parameters(vk=vk, h=h_q, l=l_q, a=a_q, b_g1=b1_q,
                               b_g2=b2_q, domain_size=m)
    r_, s_ = rng.randrange(1, R), rng.randrange(1, R)
    return {"r1cs": r1cs, "z": z, "domain": domain, "params": params,
            "dlogs": {"a": sa, "b1": sb1, "l": sl, "h": sh, "b2": sb2},
            "alpha": alpha, "beta": beta, "delta": delta, "r": r_, "s": s_,
            "rng": rng}


def prove_path(torch, timer, log2n: int, lean: bool = False):
    """Stage, prove and time the chain at 2^log2n constraints through
    the engine's default routing; check h(x), the MSMs and the proof
    exactly, and the proof by the pairing check.  The dense path (no
    "g1abl" staged) also proves through GpuEngine(msm_style="fused")
    and times its MSMs there.  lean (the 2^20 path): the domain's
    tables built and timed apart before staging, no rerun of the curve
    checks, no breakdowns, no restaging; h split by kernel in place."""
    from za_tpu_torch.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul
    from za_tpu_torch.engine import _build, ntt as NTT
    from za_tpu_torch.engine.engine import GpuEngine
    from za_tpu_torch.engine.field import limbs_to_ints
    from za_tpu_torch.groth16.prove import prove

    t_phase = t0 = time.time()
    inp = chain_inputs(log2n)
    r1cs, z, domain, params = (inp[k] for k in ("r1cs", "z", "domain",
                                                "params"))
    sa, sb1, sl, sh, sb2 = (inp["dlogs"][k] for k in ("a", "b1", "l", "h",
                                                      "b2"))
    alpha, beta, delta, r_, s_, rng = (inp[k] for k in (
        "alpha", "beta", "delta", "r", "s", "rng"))
    n, ni = r1cs.num_constraints, r1cs.num_inputs
    m = domain.size
    inputs_s = time.time() - t0
    log(f"2^{log2n} inputs: n={n} domain={m} ({inputs_s:.1f}s)")

    eng = GpuEngine()
    extra = {"inputs_s": inputs_s}
    if lean:   # the tables of DeviceDomain(m), built on the host
        t0 = time.time()
        eng._domain(m)
        extra["domain_tables_s"] = time.time() - t0
        extra["base_mem_bytes"] = torch.cuda.memory_allocated()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if lean:
        staged, stage_s = timer(lambda: eng.stage_params(params, r1cs))
        check_s = checks = None
    else:
        (staged, stage_s), check_s, checks = timed_curve_checks(
            torch, lambda: timer(lambda: eng.stage_params(params, r1cs)))
        assert checks > 0, "staging checked no raw query against the curve"
    stage_launches = launch_counts()
    _build.reset_launches()
    modes0 = dict(NTT.PREFIX_LAUNCHES)
    proof, prove_cold_s = timer(
        lambda: prove(params, r1cs, z, r=r_, s=s_, engine=eng))
    per_proof = launch_counts()
    per_proof.update({f"ntt_prefix_fr.{k}": v - modes0.get(k, 0)
                      for k, v in NTT.PREFIX_LAUNCHES.items()})
    launches = {"default": {k: v + stage_launches[k]
                            for k, v in launch_counts().items()}}
    tree = "g1abl" in staged
    check_tail_launches(per_proof, staged, log2n)
    log(f"2^{log2n} run {time.time() - t0:.1f}s (stage {stage_s:.2f}s, "
        f"first prove {prove_cold_s:.2f}s, {'tree' if tree else 'dense'}); "
        f"launches {launches['default']}")

    # timed runs of the device compute, as bench.py splits it
    z_l = eng.witness_limbs_dev(z)
    zaux = z_l[:, ni:]
    out = {}

    def msms(e, st_):
        st = {}
        if "g1abl" in st_:
            out["g1abl"], st["msm_g1abl"] = timer(
                lambda: e.msm_g1_many(st_["g1abl"], [z_l, z_l, zaux]))
            out["g1h"], st["msm_g1h"] = timer(
                lambda: e.msm_g1_many(st_["g1h"], [out["h"]]))
        else:
            out["g1x4"], st["msm_g1x4"] = timer(
                lambda: e.msm_g1_many(st_["g1x4"],
                                      [z_l, z_l, zaux, out["h"]]))
        out["b2"], st["msm_b2"] = timer(
            lambda: e.msm_g2_many(st_["b_g2x"], [z_l]))
        return st

    def prove_compute():
        st = {}
        out["h"], st["h"] = timer(
            lambda: eng.h_coeffs_limbs(r1cs, z_l, domain))
        st.update(msms(eng, staged))
        return st

    stages, totals, warm = median_runs(prove_compute)
    if tree and not lean:   # the engine's stage timer, off and on
        extra["stage_timer"] = metrics_on_off(
            torch, prove_compute,
            lambda: prove(params, r1cs, z, r=r_, s=s_, engine=eng), proof,
            statistics.median(totals))
        log(f"2^{log2n} stage timer: on {extra['stage_timer']['ratio']:.3f}"
            f" of device compute; proofs equal on and off")
    torch_ops = h_torch_ops(eng, r1cs, z_l, domain)
    assert not any(torch_ops.values()), f"h(x) ran tensor code: {torch_ops}"
    h_in = h_inline(torch, eng, r1cs, z_l, domain)
    if lean:
        extra["msm_inline_ms"] = msm_launch_split(torch, eng, staged, z_l,
                                                  out["h"], ni)
    else:
        parts = breakdown(timer, eng, r1cs, z_l, domain, staged, out["h"])
        inline = median_split(lambda: msm_breakdowns(
            torch, eng, staged, z_l, out["h"], ni, sync=False))
        tail = msm_tail_torch_ops(eng, staged, z_l, out["h"], ni)
    eng.r1cs_satisfied(r1cs, z_l)
    sat_ok, sat_s = timer(lambda: eng.r1cs_satisfied(r1cs, z_l))
    peak = torch.cuda.max_memory_allocated()
    # after the launch counts and the peak: the restagings add to neither
    if not lean:
        check_ab = stage_check_on_off(timer, params, r1cs)

    # exact checks on the host
    t0 = time.time()
    assert sat_ok, "sat check failed on a satisfied witness"
    h = limbs_to_ints(out["h"].cpu().numpy())
    assert len(h) == m - 1
    tpt = rng.randrange(2, R)
    lag = domain.lagrange_at(tpt)
    az, bz, cz = r1cs.eval_constraints(z)
    az = az + list(z[:ni])
    A = sum(a * lag[j] for j, a in enumerate(az)) % R
    B = sum(b * lag[j] for j, b in enumerate(bz)) % R
    C = sum(c * lag[j] for j, c in enumerate(cz)) % R
    ht = 0
    for c in reversed(h):
        ht = (ht * tpt + c) % R
    assert ht * (pow(tpt, m, R) - 1) % R == (A * B - C) % R, "h(x) identity"
    zs = [v % R for v in z]
    want = {
        "a": pooled_dot(zs, sa), "b1": pooled_dot(zs, sb1),
        "l": pooled_dot(zs[ni:], sl), "h": pooled_dot(h, sh),
        "b2": pooled_dot(zs, sb2),
    }

    def check_msms(tag):
        if "g1abl" in out:
            got = dict(zip("a b1 l".split(), out.pop("g1abl")))
            got["h"] = out.pop("g1h")[0]
        else:
            got = dict(zip("a b1 l h".split(), out.pop("g1x4")))
        for k in ("a", "b1", "l", "h"):
            assert got[k] == g1_mul(G1_GEN, want[k]), f"{tag}: msm {k}"
        assert out.pop("b2")[0] == g2_mul(G2_GEN, want["b2"]), f"{tag}: b_g2"

    check_msms(f"2^{log2n}")
    pa = (alpha + want["a"] + r_ * delta) % R
    pb = (beta + want["b2"] + s_ * delta) % R
    pb1 = (beta + want["b1"] + s_ * delta) % R
    pc = (want["l"] + want["h"] + s_ * pa + r_ * pb1 - r_ * s_ * delta) % R
    assert proof.a == g1_mul(G1_GEN, pa), "proof A"
    assert proof.b == g2_mul(G2_GEN, pb), "proof B"
    assert proof.c == g1_mul(G1_GEN, pc), "proof C"
    assert pairing_accepts(inp, proof, pa, pb, pc), "pairing check"
    log(f"2^{log2n} checks passed ({time.time() - t0:.1f}s)")

    result = {
        "metric": f"groth16_prove_device_compute_{1 << log2n}c",
        "value": statistics.median(totals),
        "unit": "s",
        "route": "tree" if tree else "dense",
        "stages_s": stages,
        "runs_s": totals,
        "warmup_s": warm,
        "stage_s": stage_s,
        "prove_cold_s": prove_cold_s,
        "sat_check_s": sat_s,
        "h_torch_ops": torch_ops,
        "h_inline_ms": h_in,
        "launches_per_proof": per_proof,
        "constraints": n,
        "domain": m,
        "peak_mem_bytes": peak,
        "pairing_ok": True,
        **extra,
    }
    if lean:
        result["layout"] = {tag: [t.chunk_cols, t.chunks]
                            for tag, t in staged.items()}
    else:
        result.update({
            "breakdown_s": parts, "msm_inline_s": inline,
            "msm_tail_torch_ops": tail, "curve_check_s": check_s,
            "curve_checks": checks, "stage_check_on_off_s": check_ab})
    ctx = {"eng": eng, "staged": staged, "z_l": z_l, "h": out["h"],
           "params": params, "r1cs": r1cs, "m": m,
           "per_proof": per_proof, "inp": inp, "proof": proof,
           "pabc": (pa, pb, pc)}
    if not tree:
        # the same prove at radix 4, staged anew by a fused-style engine
        feng = GpuEngine(msm_style="fused")
        _build.reset_launches()
        fstaged, fstage_s = timer(lambda: feng.stage_params(params, r1cs))
        fproof = prove(params, r1cs, z, r=r_, s=s_, engine=feng)
        launches["fused"] = launch_counts()
        assert fstaged is not staged and fstaged["g1x4"].radix == 4
        assert fproof == proof, "fused-style proof"
        msms(feng, fstaged)
        check_msms("fused")
        fstages, ftotals, _ = median_runs(lambda: msms(feng, fstaged))
        check_msms("fused, timed")
        result["fused"] = {"stages_s": fstages, "runs_s": ftotals,
                           "stage_s": fstage_s}
        ctx["fstaged"] = fstaged
        log(f"fused proof and MSMs checked: {fstages}; "
            f"launches {launches['fused']}")
    result["launches"] = launches
    result["phase_s"] = time.time() - t_phase
    return result, launches, ctx


def pairing_accepts(inp, proof, pa, pb, pc) -> bool:
    """The pairing check (groth16.verify_proof) of a proof over the
    synthetic pk.  Its pool queries hold no QAP, so the vk's IC point
    for the constant input is the one solved from the host's discrete
    logs of the expected proof (pa, pb, pc): e(A, B) = e(alpha, beta)
    e(IC, gamma) e(C, delta) with gamma = 1, IC = ic0 + x ic1, ic1 = 1."""
    import dataclasses

    from za_tpu_torch.curve import G1_GEN, R, g1_mul
    from za_tpu_torch.groth16 import verify_proof

    x = inp["z"][1] % R
    ic0 = (pa * pb - inp["alpha"] * inp["beta"] - pc * inp["delta"]
           - x) % R
    vk = dataclasses.replace(inp["params"].vk,
                             ic=[g1_mul(G1_GEN, ic0), G1_GEN])
    return verify_proof(vk, proof, [x])


def timed_curve_checks(torch, fn):
    """fn() with the coordinates of every staging curve check
    (engine.ec.on_curve) kept, then each check run again on them apart,
    timed by CUDA events -> (fn's result, seconds in the checks, number
    of checks).  Keeping them adds no sync to fn, so its time is read as
    the parent's was."""
    from za_tpu_torch.engine import ec

    inner, kept = ec.on_curve, []

    def keep(*args):
        kept.append(args)
        return inner(*args)

    ec.on_curve = keep
    try:
        out = fn()
    finally:
        ec.on_curve = inner
    timer = Timer(torch)
    spent = [timer(lambda: inner(*args).all())[1] for args in kept]
    return out, sum(spent), len(spent)


def stage_check_on_off(timer, params, r1cs) -> dict:
    """Staging of the same raw pk by fresh engines with the curve check
    on and off, in turns (on, off, off, on) -> {"on": [s, s], "off":
    [s, s]}; the check is switched off by treating no query as raw."""
    import dataclasses

    import za_tpu_torch.engine.engine as E

    raw, out = E._raw, {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        if mode == "off":
            E._raw = lambda queries: False
        try:
            fresh = dataclasses.replace(params)  # no staging cache
            _, dt = timer(lambda: E.GpuEngine().stage_params(fresh, r1cs))
        finally:
            E._raw = raw
        out[mode].append(dt)
    return out


def off_curve_refused(params, r1cs) -> dict:
    """Copies of a raw pk with one point moved off the curve (G1: y of
    a's column 1) or off the twist (G2: y.c0 of b_g2's column 1, the
    low bit of each flipped) -> {group: FormatError text}; staging must
    raise for each."""
    import dataclasses

    from za_tpu_torch.engine.engine import GpuEngine
    from za_tpu_torch.groth16.format import FormatError, G1_KEYS, G2_KEYS

    out = {}
    for g, name, key, keys in (("g1", "a", "y", G1_KEYS),
                               ("g2", "b_g2", "y0", G2_KEYS)):
        q = getattr(params, name)
        arrs = {k: getattr(q, k).copy() for k in keys}
        arrs[key][0, 1] ^= 1
        bad = dataclasses.replace(params, **{name: type(q)(**arrs)})
        try:
            GpuEngine().stage_params(bad, r1cs)
        except FormatError as exc:
            out[g] = str(exc)
        assert out.get(g) == f"pk {g} query point not on curve", \
            f"an off-curve raw {g} point staged: {out.get(g)!r}"
    log(f"off-curve raw points refused: {out}")
    return out


def h_torch_ops(eng, r1cs, z_l, domain) -> dict:
    """One h_coeffs_limbs with the tensor code it must not run counted:
    torch field products, the limb packing (F.pack, which the matvec
    made unnecessary by taking the uploaded witness), the plain matvec,
    the NTT's tensor scaling and the prefix modes' tensor versions ->
    {name: calls}."""
    from za_tpu_torch.engine import field as F, ntt as NTT, r1cs as RC

    calls = {}
    patched = [(F.FR, "mul"), (F, "pack"), (NTT, "_scale"),
               (NTT, "load_plain"),
               (NTT, "store_plain"), (NTT, "ntt_prefix_plain"),
               (RC, "matvec_plain")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patched]

    def counting(name, fn):
        def wrapped(*a, **k):
            if name in ("load_plain", "store_plain") and all(
                    v is None or v is False for v in a[1:]):
                return fn(*a, **k)  # the identity: no mode given
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    for obj, name, fn in saved:
        calls[name] = 0
        setattr(obj, name, counting(name, fn))
    try:
        eng.h_coeffs_limbs(r1cs, z_l, domain)
    finally:
        for obj, name, fn in saved:
            if obj is F.FR:
                del obj.mul      # back to the class's method
            else:
                setattr(obj, name, fn)
    return calls


def breakdown(timer, eng, r1cs, z_l, domain, staged, h):
    """Where h(x) and each MSM spend their time: the engine's steps
    timed one by one (CUDA events, each ending in a sync); the plain
    matvec (torch code) leg by leg, each leg held equal to the
    kernel's."""
    import torch

    from za_tpu_torch.engine import field as F, msm_dense as MD, ntt as NTT
    from za_tpu_torch.engine import r1cs as RC

    m = domain.size
    dom = eng._domain(m)
    t = {}
    legs, t["h.matvec3"] = timer(lambda: eng._legs(r1cs, z_l, m))
    csr = RC.r1cs_csr(r1cs, m, eng.device)
    for k, name in enumerate("AABC"):   # leg A twice: the first warms up
        k = max(k - 1, 0)
        lo, hi = (int(v) for v in csr.row_ptr[[k * m, (k + 1) * m]])
        leg = RC.Csr(csr.row_ptr[k * m:(k + 1) * m + 1] - lo,
                     csr.cols[lo:hi], csr.coeffs[:, lo:hi].contiguous(), m)
        got, t[f"h.matvec_plain.{name}"] = timer(
            lambda: RC.matvec_plain(leg, z_l))
        assert torch.equal(got[:, 0], legs[:, k]), f"matvec leg {name}"
    t.update(fourstep_breakdown(timer, dom, legs))
    x, t["h.intt3"] = timer(lambda: NTT.transform(dom, legs, True))
    x, t["h.coset_ntt3"] = timer(
        lambda: NTT.transform(dom, x, False, scale_in=dom.coset_pow))
    hc, t["h.coset_intt"] = timer(lambda: NTT.transform(
        dom, x, True, combine=True, scale_out=dom.h_out))
    assert torch.equal(hc.reshape(F.NLIMBS, m)[:, :m - 1], h), "h steps"
    t.update(median_split(lambda: msm_breakdowns(
        torch, eng, staged, z_l, h, r1cs.num_inputs, sync=True)))
    for tag, tabs, _ in msm_queries(staged, z_l, h, r1cs.num_inputs):
        if isinstance(tabs, MD.DenseTables):  # built once per pk, at staging
            _, t[f"{tag}.multiples_at_staging"] = timer(
                lambda: MD.build_tables((tabs.x[0], tabs.y[0], tabs.z[0]),
                                        tabs.is_g2, tabs.radix))
    return t


def median_split(fn, reps: int = 3) -> dict:
    """Per-key medians of reps runs of fn() -> {name: seconds}."""
    runs = [fn() for _ in range(reps)]
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


# the aten ops that launch no device work: allocations and views
FREE_OPS = {"empty", "empty_like", "empty_strided", "view", "_unsafe_view",
            "alias", "detach", "select", "slice", "as_strided", "expand",
            "unsqueeze", "squeeze", "permute", "t", "transpose"}


def check_tail_launches(per_proof, staged, log2n) -> None:
    """A prove runs a lane fold per MSM, a carry per tree MSM and no
    elementwise ec_add (staging alone runs it)."""
    tree = "g1abl" in staged
    want = {"ec_fold_g1": 2 if tree else 1, "ec_fold_g2": 1,
            "ec_add_g1": 0, "ec_add_g2": 0,
            "ec_carry_g1": 2 if tree else 0, "ec_carry_g2": int(tree)}
    got = {k: per_proof[k] for k in want}
    assert got == want, f"2^{log2n}: folds, carries and adds a proof: {got}"


def msm_tail_torch_ops(eng, staged, z_l, h, ni) -> dict:
    """One prove's MSMs (CT.msm_tree / MD.msm_dense on the staged
    queries) with every aten op and kernel launch logged in order ->
    {tag: {"ops": the ops other than allocations and views that run
    after the first tree-level or window-sum launch, "launches": the
    kernel launches from there on}}.  Past that point the chunk loop's
    levels, the carry, the lane fold and Horner must be kernels alone."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from za_tpu_torch.engine import _build, cuda_tree as CT
    from za_tpu_torch.engine import msm_dense as MD, msm_tree as MT

    body = ("tree_level0_", "tree_level_", "dense_window_sums_",
            "dense4_window_sums_")
    events = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            events.append(("op", func.overloadpacket.__name__))
            return func(*args, **(kwargs or {}))

    call = _build.Kernel.__call__

    def logged(self, *args):
        events.append(("launch", self.name))
        return call(self, *args)

    out = {}
    for tag, tabs, scal in msm_queries(staged, z_l, h, ni):
        sc = eng._scalars(tabs, scal)
        events.clear()
        _build.Kernel.__call__ = logged
        try:
            with Log():
                if isinstance(tabs, MT.AffineTables):
                    CT.msm_tree(tabs, sc)
                else:
                    MD.msm_dense(tabs, sc)
        finally:
            _build.Kernel.__call__ = call
        first = next((i for i, (kind, name) in enumerate(events)
                      if kind == "launch" and name.startswith(body)), None)
        assert first is not None, f"{tag}: no tree level or window sums ran"
        tail = events[first:]
        launches = {}
        for kind, name in tail:
            if kind == "launch" and not name.startswith(body):
                launches[name] = launches.get(name, 0) + 1
        out[tag] = {"ops": [name for kind, name in tail
                            if kind == "op" and name not in FREE_OPS],
                    "launches": launches}
        g = "g2" if tabs.is_g2 else "g1"
        want = {f"ec_fold_{g}": 1, f"horner_{g}": 1}
        if isinstance(tabs, MT.AffineTables):
            want[f"ec_carry_{g}"] = 1
        assert not out[tag]["ops"] and launches == want, \
            f"{tag}: the MSM tail is not its kernels alone: {out[tag]}"
    return out


def msm_queries(staged, z_l, h, ni):
    """-> [(tag, staged tables, scalar vectors)] of one prove's MSMs."""
    if "g1abl" in staged:
        return [("g1abl", staged["g1abl"], [z_l, z_l, z_l[:, ni:]]),
                ("g1h", staged["g1h"], [h]), ("b2", staged["b_g2x"], [z_l])]
    return [("g1x4", staged["g1x4"], [z_l, z_l, z_l[:, ni:], h]),
            ("b2", staged["b_g2x"], [z_l])]


def msm_breakdowns(torch, eng, staged, z_l, h, ni, sync: bool) -> dict:
    """Each MSM of one prove split into its steps (tree: digits, then per
    chunk level 0 and the levels, summed over the chunks, the carry,
    lane fold, Horner; dense: digits, window sums, lane fold, Horner),
    the steps timed alone (sync) or back to back inside the stage, and
    the stage's span ("{tag}.total")."""
    from za_tpu_torch.engine import msm_tree as MT

    t = {}
    for tag, tabs, scal in msm_queries(staged, z_l, h, ni):
        sc = eng._scalars(tabs, scal)
        split = Split(torch, sync)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if isinstance(tabs, MT.AffineTables):
            tree_steps(split, tabs, sc, tag)
        else:
            dense_steps(split, tabs, sc, tag)
        b.record()
        t.update(split.times())
        t[f"{tag}.total"] = a.elapsed_time(b) / 1e3
    return t


def fourstep_breakdown(timer, dom, x):
    """One 3-leg forward transform (no modes) of the l32 legs x (8, 3,
    n) whole, then step by step: the prefix launches, the tail stage
    launches (none where m_fuse = S) and the twiddle transpose."""
    import torch

    from za_tpu_torch.engine import ntt as NTT

    fs = dom.fourstep
    assert fs is not None, f"2^{dom.size.bit_length() - 1}: no four-step"
    want, total = timer(lambda: NTT.transform(dom, x, False))
    t = {"h.ntt3": total, "h.ntt3.prefix": 0.0, "h.ntt3.tail": 0.0}
    a = x.reshape(8, 3, fs.n2, fs.n1)

    def sub(a, tw, S):
        m = NTT.prefix_rows(S, a.shape[3])
        assert m >= 4, "the prefix kernel does not run"
        a, dt = timer(lambda: NTT.ntt_prefix(a, tw, m))
        t["h.ntt3.prefix"] += dt
        if m < S:
            a, dt = timer(lambda: NTT.ntt_stages(a, tw, 2 * m))
            t["h.ntt3.tail"] += dt
        return a

    a = sub(a, fs.t2_fwd, fs.n2)
    a, t["h.ntt3.twiddle"] = timer(lambda: NTT.ntt_twiddle(a, fs.inter_fwd))
    a = sub(a, fs.t1_fwd, fs.n1)
    assert torch.equal(a.reshape(8, 3, dom.size), want), \
        "four-step steps differ from NTT.transform"
    return t


def tree_steps(split, tabs, sc, tag):
    """CT.msm_tree's steps, each through split."""
    from za_tpu_torch.engine import cuda_tree as CT, msm as MSM

    g2 = tabs.is_g2
    d = split(f"{tag}.digits", lambda: CT.window_digits(tabs, sc))
    px, py, pinf = CT.partials_buffer(tabs, d.device)
    for c in range(tabs.chunks):
        out = (px[c], py[c], pinf[c])
        x, y, inf = split(f"{tag}.level0", lambda: CT.tree_level0(
            tabs.tx[c], tabs.ty[c], d[c], g2,
            out if d.shape[-1] // 2 <= CT.TAIL else None))

        def levels(x=x, y=y, inf=inf, out=out):
            while x.shape[-1] > CT.TAIL:
                x, y, inf = CT.tree_level(
                    x, y, inf, g2, out if x.shape[-1] // 2 <= CT.TAIL
                    else None)
            return x, y, inf

        split(f"{tag}.levels", levels)
    acc = split(f"{tag}.carry", lambda: CT.chunk_carry(px, py, pinf, g2))
    w = split(f"{tag}.lane_fold", lambda: MSM.lane_fold(acc, g2))
    return split(f"{tag}.horner", lambda: MSM.horner_windows(w, g2, 4))


def legacy_carry_api(CT) -> None:
    """For the tools' --root: a cuda_tree whose carry runs a launch a
    chunk (chunk_carry(acc, x, y, inf, is_g2)) gets this one's
    interface over its own launches: partials_buffer hands out slots, a
    level given a slot as out keeps its output there (no copy), and
    chunk_carry runs the old carry over the slots, chunk by chunk."""
    if hasattr(CT, "partials_buffer"):
        return
    carry, level0, level = CT.chunk_carry, CT.tree_level0, CT.tree_level

    class Slots(list):
        def __getitem__(self, c):
            return self, c

    def keep(res, out):
        if out is not None:
            slots, c = out[0]
            list.__setitem__(slots, c, res)
        return res

    def partials_buffer(tables, device):
        slots = Slots([None] * tables.chunks)
        return slots, slots, slots

    def chunk_carry(x, y, inf, is_g2):   # slots, or stacked tensors
        acc = None
        for part in (list.__iter__(x) if isinstance(x, Slots)
                     else zip(x, y, inf)):
            acc = carry(acc, *part, is_g2)
        return acc

    CT.partials_buffer, CT.chunk_carry = partials_buffer, chunk_carry
    CT.tree_level0 = lambda tx, ty, d, g2, out=None: keep(
        level0(tx, ty, d, g2), out)
    CT.tree_level = lambda x, y, inf, g2, out=None: keep(
        level(x, y, inf, g2), out)


def legacy_dense_api(MD) -> None:
    """For the tools' --root: a msm_dense from before segments gets
    plan() = (its lanes(), S = 1) and window sums that take S = 1."""
    if hasattr(MD, "plan"):
        return
    sums, plain = MD.dense_window_sums, MD.dense_window_sums_plain
    MD.plan = lambda t: (MD.lanes(t.m, t.n, t.radix), 1)
    MD.dense_window_sums = lambda tabs, d, L, S=1: sums(tabs, d, L)
    MD.dense_window_sums_plain = lambda tabs, d, L, S=1: plain(tabs, d, L)


def dense_steps(split, tabs, sc, tag):
    """MD.msm_dense's steps, each through split."""
    from za_tpu_torch.engine import msm as MSM, msm_dense as MD

    g2 = tabs.is_g2
    d = split(f"{tag}.digits", lambda: MD.digits(sc, tabs.radix))
    L, S = MD.plan(tabs)
    acc = split(f"{tag}.window_sums",
                lambda: MD.dense_window_sums(tabs, d, L, S))
    w = split(f"{tag}.lane_fold", lambda: MSM.lane_fold(acc, g2))
    return split(f"{tag}.horner", lambda: MSM.horner_windows(
        w, g2, MD.BITS[tabs.radix]))


# -- phase 4: a verifying proof ------------------------------------------------------


def real_proof():
    """The trusted setup on the card against the host's (fixed toxic
    waste: equal Parameters bytes, with densities), then a proof on the
    card from the card's parameters (its domain, 512, through the
    four-step: 32 x 16) -> (the prove's launches, the setup's)."""
    import io

    from za_tpu_torch.engine import _build
    from za_tpu_torch.engine.engine import GpuEngine
    from za_tpu_torch.groth16 import generate_parameters, prove, verify_proof
    from za_tpu_torch.groth16.format import write_parameters

    t0 = time.time()
    r1cs, z = chain_r1cs(510)
    toxic = dict(tau=11, alpha=3, beta=5, gamma=7, delta=9)
    host = generate_parameters(r1cs, **toxic)
    t1 = time.time()
    _build.reset_launches()
    params = generate_parameters(r1cs, **toxic, engine=GpuEngine())
    setup_launches = launch_counts()
    t2 = time.time()
    pk = []
    for p in (host, params):
        buf = io.BytesIO()
        write_parameters(buf, p, densities=r1cs.densities())
        pk.append(buf.getvalue())
    assert pk[0] == pk[1], "the card's setup differs from the host's"
    _build.reset_launches()
    proof = prove(params, r1cs, z, r=13, s=17, engine=GpuEngine())
    launches = launch_counts()
    assert "g1x4" in params._staged_cache[1], "dense staged branch not taken"
    ok = verify_proof(params.vk, proof, z[1:r1cs.num_inputs])
    log(f"510-constraint proof: setup on the host {t1 - t0:.1f}s, on the "
        f"card {t2 - t1:.1f}s (equal pk bytes), prove+verify "
        f"{time.time() - t2:.1f}s, verifies={ok}")
    assert ok, "the 510-constraint proof does not verify"
    return launches, setup_launches


# -- phase 4c: the za CLI and a prove from a pk file ---------------------------------

# bench.py's multiplier chain as circuit text (bench.py witness_bench)
CHAIN_ZA = (
    "template chain(N) {\n"
    " signal input x;\n signal output out;\n signal t[N];\n"
    " t[0] <== x * x;\n"
    " for (var i=1;i<N;i+=1) { t[i] <== t[i-1] * t[i-1] + i; }\n"
    " out <== t[N-1];\n}\ncomponent main = chain(%d);\n"
)
CLI_N = 600        # the round trip's chain: past the staged gate of 512
CLI_X = 3
# a process's start-up, timed alone: the interpreter and the modules a
# prove imports; the CUDA context (printed in seconds)
STARTUP_IMPORTS = ("import za_tpu_torch.cli, za_tpu_torch.groth16.helper, "
                   "za_tpu_torch.engine.engine")
STARTUP_CUDA = ("import time, torch; t = time.time(); "
                "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
                "print(time.time() - t)")
# the third 2^17 prove, a process of its own as a user's `za prove` is:
# argv pk, x, r, s, out -> out holds the proof.json string, the
# prove's timings, its stage_info, its launches, the process's import
# and CUDA start-up seconds and the engine's stage lines (ZA_METRICS=1
# in its environment)
PROVE_CHILD = """
import json, sys, time
t0 = time.time()
import torch
import chip_smoke as cs
from za_tpu_torch.algebra import FS
from za_tpu_torch.engine import _build
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16 import helper
import_s = time.time() - t0
pk, x, r, s, out = sys.argv[1:]
t0 = time.time()
eng = GpuEngine()
torch.zeros(1, device=eng.device)
torch.cuda.synchronize()
t = {"import_s": import_s, "cuda_init_s": time.time() - t0}
with cs.KeepLines() as keep:
    pj = helper.prove(pk, [("main.x", FS(int(x)))], engine=eng,
                      deterministic_rs=(int(r), int(s)), timings=t)
t.update(eng.stage_info)
t["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
t["launches"] = {k.name: k.launches for k in _build.KERNELS.values()}
with open(out, "w") as f:
    json.dump({"proof": pj, "timings": t, "stage_lines": keep.lines}, f)
"""


# a process's first staging with nothing run before it: the chain's
# pool queries at 2^argv[1] (chain_inputs) staged by a new GpuEngine,
# ZA_METRICS=1 in its environment -> JSON on stdout: stage_s, the
# stage lines
STAGE_CHILD = """
import json, sys, time
sys.setrecursionlimit(100000)
import torch
import chip_smoke as cs
from za_tpu_torch.engine.engine import GpuEngine
inp = cs.chain_inputs(int(sys.argv[1]))
eng = GpuEngine()
torch.zeros(1, device=eng.device)
torch.cuda.synchronize()
with cs.KeepLines() as keep:
    t0 = time.time()
    eng.stage_params(inp["params"], inp["r1cs"])
    torch.cuda.synchronize()
    stage_s = time.time() - t0
print(json.dumps({"stage_s": stage_s, "lines": keep.lines}))
"""


def cli_round_trip(root: str, work: str) -> dict:
    """python3 -m za_tpu_torch.cli setup (the card, the default engine;
    random toxic waste), prove twice (the card) and verify, then setup
    with --engine host, a prove from that pk and its verify, each a
    process of its own, on the chain at CLI_N constraints -> seconds a
    command.  The first prove interprets and writes <pk>.wtrace, the
    second replays it; both check the constraints on the device (the
    staged branch) and both proofs verify.  The second prove's seconds
    are split at helper.prove's wall; a process's imports and its CUDA
    context are timed alone."""
    d = os.path.join(work, "cli")
    os.makedirs(d)
    with open(os.path.join(d, "circuit.za"), "w") as f:
        f.write(CHAIN_ZA % CLI_N)
    with open(os.path.join(d, "input.json"), "w") as f:
        json.dump({"x": str(CLI_X)}, f)
    env = dict(os.environ, PYTHONPATH=root)
    out = {}

    def za(tag, *argv):
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m", "za_tpu_torch.cli", "-v",
                            *argv], cwd=d, env=env, capture_output=True,
                           text=True, timeout=600)
        out[tag] = time.time() - t0
        if p.returncode != 0 and tag not in ("verify_tampered",):
            raise AssertionError(f"za {' '.join(argv)}: rc {p.returncode}"
                                 f"\n{p.stdout}\n{p.stderr[-4000:]}")
        return p

    p = za("setup_s", "setup", "--verifiertype", "json")   # on the card
    assert "Setup time" in p.stderr and "(device)" in p.stderr, \
        "the CLI setup did not run on the card"
    first = za("prove1_s", "prove")
    assert os.path.exists(os.path.join(d, "proving.key.wtrace")), \
        "the first prove wrote no .wtrace"
    # -v turns the engine's stage timer on: device seconds a stage
    assert re.search(r"\[stage\] msm\.g1\.kernel\S*: [0-9.]+s device "
                     r"[0-9.]+s", first.stderr), \
        "za -v prove logged no stage line with device seconds"
    second = za("prove2_s", "prove", "--proof", "proof2.json")
    for tag, p in (("first", first), ("second", second)):
        assert "(device)" in p.stderr and "(host)" not in p.stderr, \
            f"{tag} CLI prove: constraint check not on the device"
    assert "Witness generation time" in first.stderr
    assert "Witness replay time" in second.stderr
    assert "Witness generation time" not in second.stderr, \
        "the second CLI prove re-interpreted the circuit"
    # what the second prove's process pays outside helper.prove: the
    # interpreter and the imports (timed alone), the CUDA context (timed
    # alone), input.json and proof.json
    helper_wall = re.search(r"prove wall time: ([0-9.]+)s", second.stderr)
    assert helper_wall, "the second CLI prove logged no wall time"
    out["prove2_helper_wall_s"] = float(helper_wall.group(1))
    out["prove2_outside_helper_s"] = (out["prove2_s"]
                                      - out["prove2_helper_wall_s"])
    t0 = time.time()
    subprocess.run([sys.executable, "-c", STARTUP_IMPORTS], cwd=d, env=env,
                   check=True, timeout=600)
    out["startup_import_s"] = time.time() - t0
    p = subprocess.run([sys.executable, "-c", STARTUP_CUDA], cwd=d, env=env,
                       check=True, capture_output=True, text=True,
                       timeout=600)
    out["startup_cuda_init_s"] = float(p.stdout.split()[-1])
    for proof in ("proof.json", "proof2.json"):
        p = za("verify_s", "verify", "--proof", proof)
        assert p.stdout.strip() == "OK", f"verify {proof}: {p.stdout!r}"
    # a tampered public input must not verify
    with open(os.path.join(d, "proof.json")) as f:
        pj = json.load(f)
    pj["public_inputs"][0] = str(int(pj["public_inputs"][0]) + 1)
    with open(os.path.join(d, "bad.json"), "w") as f:
        json.dump(pj, f)
    p = za("verify_tampered", "verify", "--proof", "bad.json")
    assert p.returncode == 1 and p.stdout.strip() == "INVALID", p.stdout
    out.pop("verify_tampered")
    # the host's setup: its pk proves on the card and verifies
    p = za("setup_host_s", "setup", "--engine", "host", "--pk", "host.key",
           "--verifier", "host.json", "--verifiertype", "json")
    assert "(host)" in p.stderr, "setup --engine host"
    za("prove_host_pk_s", "prove", "--pk", "host.key", "--proof",
       "proof_host.json")
    p = za("verify_s", "verify", "--verifier", "host.json", "--proof",
           "proof_host.json")
    assert p.stdout.strip() == "OK", f"verify proof_host.json: {p.stdout!r}"
    out["constraints"] = CLI_N
    log(f"CLI round trip at {CLI_N} constraints: {out}")
    return out


# -- the port's bindings on the card (phase 4c) -------------------------------------

ZA2C_DIR = os.path.join("za_tpu_torch", "bindings", "c")


def build_za2c(root: str, out: str) -> float:
    """The port's libza2c and its round trip test_za2c, built by its
    Makefile with this machine's g++ and python3-config into out ->
    seconds."""
    t0 = time.time()
    p = subprocess.run(["make", "-C", os.path.join(root, ZA2C_DIR),
                        f"BUILD={out}", os.path.join(out, "test_za2c")],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, f"libza2c build:\n{p.stdout}\n{p.stderr}"
    return time.time() - t0


def tampered(proof_json: str) -> str:
    doc = json.loads(proof_json)
    doc["public_inputs"][0] = str(int(doc["public_inputs"][0]) + 1)
    return json.dumps(doc)


def held(vk_json: str, proof_json: str, tag: str) -> None:
    """The proof verifies under the port's helper.verify; with its first
    public input changed it does not."""
    from za_tpu_torch.groth16 import helper

    assert helper.verify(vk_json, proof_json), f"{tag}: proof rejected"
    assert not helper.verify(vk_json, tampered(proof_json)), \
        f"{tag}: tampered proof accepted"


def za2c_round_trip(root: str, build: str, work: str, inputs: str,
                    pk: str | None = None) -> dict:
    """test_za2c on the default engine, the card, in a process of its
    own: setup of work/circuit.za (without pk), prove, verify, a
    tampered proof rc 2 (else the program fails) -> each call's seconds,
    the process's, and the stage_info of the GpuEngine the C ABI built;
    the proof verifies under the port's helper.verify."""
    env = dict(os.environ, ZA_TPU_ROOT=root, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in sys.path if p]))
    t0 = time.time()
    p = subprocess.run([os.path.join(build, "test_za2c"), work, "gpu",
                        inputs] + ([pk] if pk else []),
                       capture_output=True, text=True, timeout=900, env=env)
    out = {"process_s": time.time() - t0}
    lines = p.stdout.splitlines()
    assert p.returncode == 0 and lines[-1:] == ["ALL C BINDING TESTS PASS"] \
        and "tampered proof rejected ok" in lines, \
        f"test_za2c: rc {p.returncode}\n{p.stdout}\n{p.stderr[-4000:]}"
    for line in lines:
        if line.startswith("za2c "):
            _, call, sec = line.split()
            out[f"{call}_s"] = float(sec)
        elif line.startswith("engines "):
            engines = json.loads(line[len("engines "):])
    assert len(engines) == 1, f"the C ABI's GpuEngines: {engines}"
    out["stage_info"] = engines[0]
    if pk is None:
        assert "Setup time" in p.stderr and "(device)" in p.stderr, \
            "the C ABI's setup did not run on the card"
    assert "(device)" in p.stderr.split("Proving key read time")[-1], \
        "the C ABI's prove did not check the constraints on the card"
    with open(os.path.join(work, "verifier.json")) as f:
        vk_json = f.read()
    with open(os.path.join(work, "proof.json")) as f:
        held(vk_json, f.read(), "C ABI")
    return out


def load_za2py(root: str):
    """The port's Python binding, from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "za2py_torch",
        os.path.join(root, "za_tpu_torch", "bindings", "python3", "za2py.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bindings_dense(root: str, work: str, build: str, za2py) -> dict:
    """setup -> prove -> verify on the default engine (the card) at the
    round trip's CLI_N constraints, the dense route, through the C ABI
    (test_za2c) and through the Python binding -> seconds a call and
    each engine's stage_info."""
    inputs = json.dumps({"x": str(CLI_X)})
    out = {}
    for tag in ("c", "python"):
        d = os.path.join(work, f"za2{tag}_{CLI_N}")
        os.makedirs(d)
        circuit = os.path.join(d, "circuit.za")
        with open(circuit, "w") as f:
            f.write(CHAIN_ZA % CLI_N)
        if tag == "c":
            out[tag] = za2c_round_trip(root, build, d, inputs)
        else:
            pk, t = os.path.join(d, "proving.key"), {}
            t0 = time.time()
            vk = za2py.setup(circuit, pk, "json")
            t["setup_s"] = time.time() - t0
            t0 = time.time()
            proof = za2py.prove(pk, inputs)
            t["prove_s"] = time.time() - t0
            t0 = time.time()
            assert za2py.verify(vk, proof), "Python binding: verify"
            t["verify_s"] = time.time() - t0
            held(vk, proof, "Python binding")
            t["stage_info"] = dict(za2py._gpu.stage_info)
            out[tag] = t
        info = out[tag]["stage_info"]
        assert (info["source"], info["cache"]) == ("staged", None), \
            f"{tag} binding at {CLI_N}: not staged on the dense route: {info}"
    log(f"bindings at {CLI_N} constraints (dense, the card): {out}")
    return out


def chain_z(signals, r1cs, n: int, x: int) -> list:
    """The chain's witness in closed form (t[0] = x^2, t[i] = t[i-1]^2 +
    i, out = t[n-1]), placed by the R1CS's variable map."""
    from za_tpu_torch.curve import R

    t = [x * x % R]
    for i in range(1, n):
        t.append((t[-1] * t[-1] + i) % R)
    val = {"main.x": x, "main.out": t[-1]}
    val.update((f"main.t[{i}]", v) for i, v in enumerate(t))
    z = [0] * r1cs.num_vars
    z[0] = 1
    for sid, v in enumerate(r1cs.var_of_signal):
        if v is not None and sid > 0:
            z[v] = val[signals.get_by_id(sid).full_name]
    return z


def cli_path(torch, root: str) -> tuple:
    """The user's path at full width: (a) the CLI round trip; (b) the
    chain at 2^LOG2N constraints as circuit text, compiled by the port's
    Evaluator and optimizer, its pk (queries from prime-size pools,
    vk solved from their logs for the proof of a fixed r, s) written
    with format.write_pk, then helper.prove on the card three times:
    twice in one GpuEngine (the first interprets the circuit, stages
    the tables and writes <pk>.wtrace and <pk>.gpucache; the second
    replays natively and loads the cache), once in a process of its own
    (PROVE_CHILD: replays, loads).  The three proof.json strings must be equal and
    hold the exact host values -> (the phase's line, the three proves'
    launches)."""
    import shutil
    import tempfile

    from za_tpu_torch.compiler import Evaluator, Mode, optimize
    from za_tpu_torch.compiler.evaluator import Scope
    from za_tpu_torch.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul
    from za_tpu_torch.algebra import FS
    from za_tpu_torch.engine import _build
    from za_tpu_torch.engine.engine import GpuEngine
    from za_tpu_torch.engine.field import limbs_to_ints
    from za_tpu_torch.groth16 import format as fmt, helper
    from za_tpu_torch.groth16.domain import Domain
    from za_tpu_torch.groth16.r1cs import R1CS
    from za_tpu_torch.groth16.setup import Groth16Parameters, VerifyingKey
    from za_tpu_torch.native import wtrace_lib

    t_phase = time.time()
    work = tempfile.mkdtemp(prefix="za_cli_")
    try:
        result = {"metric": f"za_prove_from_pk_{1 << LOG2N}c",
                  "round_trip_s": cli_round_trip(root, work)}
        build = os.path.join(work, "za2c")
        za2py = load_za2py(root)
        bindings = {"build_s": build_za2c(root, build),
                    f"dense_{CLI_N}": bindings_dense(root, work, build,
                                                     za2py)}

        n = 1 << LOG2N
        t0 = time.time()
        ev = Evaluator(Mode.GEN_CONSTRAINTS)
        ev.eval_inline(Scope(True, None, "root"), CHAIN_ZA % n)
        result["compile_s"] = time.time() - t0
        t0 = time.time()
        cons, removed = optimize(ev.constraints, ev.signals.main_input_ids())
        r1cs = R1CS.from_constraints(ev.signals, cons, removed)
        result["optimize_r1cs_s"] = time.time() - t0
        ni, nv = r1cs.num_inputs, r1cs.num_vars
        domain = Domain.for_constraints(r1cs.num_constraints + ni)
        m = domain.size
        assert (r1cs.num_constraints, ni, m) == (n, 3, 2 * n), \
            (r1cs.num_constraints, ni, m)
        z = chain_z(ev.signals, r1cs, n, CLI_X)

        # the pk: pool queries, the expected proof from their logs
        t0 = time.time()
        rng = random.Random(SEED + 1)
        a_q, sa = pool_points(rng, nv, 67)
        l_q, sl = pool_points(rng, r1cs.num_aux, 67)
        h_q, sh = pool_points(rng, m - 1, 67)
        b2_q, sb2 = pool_points(rng, nv, 19, g2=True)
        # b_g1 on b_g2's logs, as a setup makes them: then a proof of any
        # r, s verifies (the bindings prove with random ones), not only
        # the one of rs, which the vk's IC point is solved for
        sb1 = sb2
        b1_pool = [g1_mul(G1_GEN, v) for v in sb1]
        b1_q = [b1_pool[i % len(sb1)] for i in range(nv)]
        alpha, beta, delta = (rng.randrange(1, R) for _ in range(3))
        rs = (rng.randrange(1, R), rng.randrange(1, R))
        h = limbs_to_ints(GpuEngine().h_coeffs_limbs(r1cs, z, domain).cpu())
        tpt = rng.randrange(2, R)
        lag = domain.lagrange_at(tpt)
        az, bz, cz = r1cs.eval_constraints(z)
        az = az + list(z[:ni])
        A = sum(a * lag[j] for j, a in enumerate(az)) % R
        B = sum(b * lag[j] for j, b in enumerate(bz)) % R
        C = sum(c * lag[j] for j, c in enumerate(cz)) % R
        ht = 0
        for c in reversed(h):
            ht = (ht * tpt + c) % R
        assert ht * (pow(tpt, m, R) - 1) % R == (A * B - C) % R, "h(x)"
        a_d, b_d = r1cs.densities()
        za_ = [v * d for v, d in zip(z, a_d)]
        zb_ = [v * d for v, d in zip(z, b_d)]
        want = {"a": pooled_dot(za_, sa), "b1": pooled_dot(zb_, sb1),
                "l": pooled_dot(z[ni:], sl), "h": pooled_dot(h, sh),
                "b2": pooled_dot(zb_, sb2)}
        r_, s_ = rs
        pa = (alpha + want["a"] + r_ * delta) % R
        pb = (beta + want["b2"] + s_ * delta) % R
        pb1 = (beta + want["b1"] + s_ * delta) % R
        pc = (want["l"] + want["h"] + s_ * pa + r_ * pb1
              - r_ * s_ * delta) % R
        ic0 = (pa * pb - alpha * beta - pc * delta - sum(z[1:ni])) % R
        vk = VerifyingKey(
            alpha_g1=g1_mul(G1_GEN, alpha), beta_g1=g1_mul(G1_GEN, beta),
            beta_g2=g2_mul(G2_GEN, beta), gamma_g2=G2_GEN,
            delta_g1=g1_mul(G1_GEN, delta),
            delta_g2=g2_mul(G2_GEN, delta),
            ic=[g1_mul(G1_GEN, ic0)] + [G1_GEN] * (ni - 1))
        params = Groth16Parameters(vk=vk, h=h_q, l=l_q, a=a_q, b_g1=b1_q,
                                   b_g2=b2_q, domain_size=m)
        result["pk_inputs_s"] = time.time() - t0
        pk = os.path.join(work, "proving.key")
        t0 = time.time()
        with open(pk, "wb") as f:
            fmt.write_pk(f, ev.collected_asts, cons, removed, params,
                         densities=(a_d, b_d))
        result["pk_write_s"] = time.time() - t0
        result["pk_bytes"] = os.path.getsize(pk)
        # the compiled circuit, for the setup on the card
        circuit = {"asts": ev.collected_asts, "cons": cons,
                   "removed": removed, "r1cs": r1cs, "z": z}
        del ev, params, a_q, b1_q, l_q, h_q, b2_q
        log(f"2^{LOG2N} pk from circuit text: compile "
            f"{result['compile_s']:.1f}s, {result['pk_bytes']} bytes")

        # three proves, the launches counted over them: two in this
        # process, one in a process of its own
        inputs = [("main.x", FS(CLI_X))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        eng = GpuEngine()
        proves = []
        for k in range(2):
            t = {}
            pj = helper.prove(pk, inputs, engine=eng,
                              deterministic_rs=rs, timings=t)
            t.update(eng.stage_info)
            proves.append((pj, t))
            if k == 0:
                assert os.path.isdir(pk + helper.GPUCACHE_SUFFIX) and \
                    os.path.exists(pk + ".wtrace"), "no .wtrace/.gpucache"
        launches = launch_counts()
        result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        assert wtrace_lib() is not None, "the native replay did not build"
        del eng
        torch.cuda.empty_cache()

        def own_process(tag, **env):
            """PROVE_CHILD under ZA_METRICS=1 -> (its output, seconds)."""
            out = os.path.join(work, f"{tag}.json")
            t0 = time.time()
            subprocess.run([sys.executable, "-c", PROVE_CHILD, pk,
                            str(CLI_X), str(rs[0]), str(rs[1]), out],
                           cwd=root, env=dict(os.environ, PYTHONPATH=root,
                                              ZA_METRICS="1", **env),
                           check=True, timeout=900)
            seconds = time.time() - t0
            with open(out) as f:
                return json.load(f), seconds

        child, process_s = own_process("child")
        t = child["timings"]
        launches = {k: v + t["launches"].get(k, 0)
                    for k, v in launches.items()}
        proves.append((child["proof"], t))
        # a fourth prove in a process of its own that stages the tables
        # (no <pk>.gpucache read or written): a process's first staging
        # and first constraint check, split by the stage timer
        fresh, fresh_s = own_process("staging", ZA_DEVCACHE="0")
        ft = fresh["timings"]
        launches = {k: v + ft["launches"].get(k, 0)
                    for k, v in launches.items()}
        assert fresh["proof"] == proves[0][0], "the staging child's proof"
        assert (ft["witness"], ft["source"], ft["cache"]) == (
            "replay_native", "staged", None), ft
        keys = ("sat_check_s", "prove_s", "wall_s", "pk_read_s",
                "witness_s", "import_s", "cuda_init_s")
        result["stage_metrics"] = {
            "metric": f"stage_metrics_{1 << LOG2N}c",
            "cache_load": {"lines": parse_stage_lines(child["stage_lines"]),
                           "process_s": process_s, "cache_load_s":
                           t["cache_load_s"],
                           **{k: t[k] for k in keys}},
            "staging": {"lines": parse_stage_lines(fresh["stage_lines"]),
                        "process_s": fresh_s, "stage_s": ft["stage_s"],
                        **{k: ft[k] for k in keys}}}
        t0 = time.time()
        p = subprocess.run([sys.executable, "-c", STAGE_CHILD, str(LOG2N)],
                           cwd=root, env=dict(os.environ, PYTHONPATH=root,
                                              ZA_METRICS="1"),
                           check=True, capture_output=True, text=True,
                           timeout=900)
        first = json.loads(p.stdout.splitlines()[-1])
        result["stage_metrics"]["first_staging"] = {
            "lines": parse_stage_lines(first["lines"]),
            "stage_s": first["stage_s"], "process_s": time.time() - t0}
        for tag, lines in (("cache_load", child["stage_lines"]),
                           ("staging", fresh["stage_lines"]),
                           ("first_staging", first["lines"])):
            assert lines and all(" device " in x for x in lines
                                 if x.startswith("[stage]")), \
                f"{tag}: stage lines without device seconds: {lines[:3]}"
        log(f"2^{LOG2N} stage lines (own process, staging): "
            f"{fresh['stage_lines']}")
        result["fresh_process"] = {
            "process_s": process_s, "import_s": t["import_s"],
            "cuda_init_s": t["cuda_init_s"],
            "outside_helper_s": process_s - t["wall_s"],
            "peak_mem_bytes": t["peak_mem_bytes"]}
        ways = [(t["witness"], t["source"], t["cache"]) for _, t in proves]
        assert ways == [("interpret", "staged", "miss")] + [
            ("replay_native", "cache", "hit")] * 2, ways
        assert proves[0][0] == proves[1][0] == proves[2][0], "proofs differ"
        proof, pub = fmt.proof_from_json(proves[0][0])
        assert pub == z[1:ni], "public inputs"
        assert proof.a == g1_mul(G1_GEN, pa), "proof A"
        assert proof.b == g2_mul(G2_GEN, pb), "proof B"
        assert proof.c == g1_mul(G1_GEN, pc), "proof C"
        assert not os.path.exists(pk + ".devcache")
        cache = pk + helper.GPUCACHE_SUFFIX
        result.update({
            "constraints": n, "domain": m, "route": "tree",
            "witness_interpret_s": proves[0][1]["witness_s"],
            "witness_replay_s": [t["witness_s"] for _, t in proves[1:]],
            "stage_s": proves[0][1]["stage_s"],
            "cache_save_s": proves[0][1]["cache_save_s"],
            "cache_load_s": [t["cache_load_s"] for _, t in proves[1:]],
            "cache_bytes": proves[1][1]["cache_bytes"],
            "cache_disk_bytes": sum(
                os.path.getsize(os.path.join(cache, f))
                for f in os.listdir(cache)),
            "wtrace_bytes": os.path.getsize(pk + ".wtrace"),
            "wtrace_dump_s": proves[0][1]["wtrace_dump_s"],
            **{k: [t[k] for _, t in proves] for k in (
                "pk_read_s", "digest_s", "wtrace_load_s", "witness_s",
                "sat_check_s", "prove_s", "self_verify_s", "wall_s")},
            "launches": launches,
        })
        log(f"2^{LOG2N} from the pk: three equal proofs (the third in a "
            f"process of its own, {process_s:.1f}s); helper walls "
            f"{result['wall_s']}, stage {result['stage_s']:.2f}s against "
            f"cache loads {result['cache_load_s']}")

        # the bindings from the 2^17 pk on the card (the tree route, its
        # tables from <pk>.gpucache): the C ABI in a process of its own,
        # the Python binding in this one
        d = os.path.join(work, f"za2c_{n}")
        os.makedirs(d)
        vk_json = fmt.vk_to_json(vk, r1cs.input_names)
        with open(os.path.join(d, "verifier.json"), "w") as f:
            f.write(vk_json)
        inputs_json = json.dumps({"x": str(CLI_X)})
        tree = {"c": za2c_round_trip(root, build, d, inputs_json, pk)}
        t0 = time.time()
        pj = za2py.prove(pk, inputs_json)
        tree["python"] = {"prove_s": time.time() - t0,
                          "stage_info": dict(za2py._gpu.stage_info)}
        held(vk_json, pj, "Python binding at 2^17")
        for tag, info in ((k, v["stage_info"]) for k, v in tree.items()):
            assert (info["source"], info["cache"]) == ("cache", "hit"), \
                f"{tag} binding at 2^{LOG2N}: tables not from the cache: {info}"
        bindings[f"tree_{n}"] = tree
        result["bindings"] = bindings
        za2py._gpu = None
        torch.cuda.empty_cache()
        log(f"bindings at 2^{LOG2N} (tree, the card): {tree}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["phase_s"] = time.time() - t_phase
    return result, launches, circuit


# -- phase 4d: the trusted setup on the card --------------------------------------

# fixed toxic waste of the 2^17 setup
SETUP_TOXIC = dict(tau=0x5E7C0DE, alpha=3, beta=5, gamma=7, delta=9)
# scalars of the host setup's timing sample, each group
HOST_SAMPLE = 1024
# the largest query the setup makes on bench.py's ladder: h at 2^20
# constraints, 2^21 - 1 points (its peak memory is reported)
H_2_20 = (1 << 21) - 1


def rlc_check(eng, rng, points, scalars, is_g2: bool) -> None:
    """sum_i rho_i P_i (the port's msm_g1 / msm_g2, dense route, complete
    adds) equals (sum_i rho_i s_i mod r) G, for random rho_i: every P_i
    = s_i G but with a chance of 1/r."""
    from za_tpu_torch.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul

    rho = [rng.randrange(R) for _ in points]
    k = sum(a * b for a, b in zip(rho, scalars)) % R
    if is_g2:
        assert eng.msm_g2(points, rho) == g2_mul(G2_GEN, k)
    else:
        assert eng.msm_g1(points, rho) == g1_mul(G1_GEN, k)


def setup_path(torch, circuit: dict) -> tuple:
    """The setup on the card at 2^LOG2N constraints (the chain compiled
    by cli_path, fixed toxic waste): generate_parameters with
    GpuEngine(), timed step by step (qap_evals_at_tau, the scalars, each
    fixed-base batch split into its table, upload, device and host-point
    seconds); every query held exactly by a random linear combination
    against the scalars recomputed on the host; the vk's points against
    host scalar multiplication; the pk written, a proof through
    helper.prove on the card, exact against the host's values of A, B,
    C and accepted by the pairing check against the setup's vk; the host
    setup's seconds extrapolated from HOST_SAMPLE scalar multiplications
    per group; the h query of 2^20 constraints (H_2_20 scalars) through
    fixed_base_g1 for its peak memory -> (the phase's line, the setup's
    launches, the kernel rows' inputs)."""
    import shutil
    import tempfile

    from za_tpu_torch.algebra import FS
    from za_tpu_torch.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul
    from za_tpu_torch.engine import _build
    from za_tpu_torch.engine.engine import GpuEngine
    from za_tpu_torch.groth16 import format as fmt, helper, verify_proof
    from za_tpu_torch.groth16 import setup as S
    from za_tpu_torch.groth16.domain import Domain, batch_inverse

    t_phase = time.time()
    r1cs, z = circuit["r1cs"], circuit["z"]
    ni, nv = r1cs.num_inputs, r1cs.num_vars
    tox = SETUP_TOXIC
    result = {"metric": f"groth16_setup_device_{1 << LOG2N}c",
              "constraints": r1cs.num_constraints, "vars": nv}

    # the setup, timed step by step by generate_parameters itself
    eng = GpuEngine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # the earlier paths' tensors
    _build.reset_launches()
    t0 = time.time()
    st = {}
    params = S.generate_parameters(r1cs, **tox, engine=eng, timings=st)
    wall = time.time() - t0
    launches = launch_counts()
    calls = st["batches"]
    result.update({
        "setup_s": wall, "qap_evals_s": st["qap_evals_s"],
        "scalars_s": st["scalars_s"], "fixed_base": calls,
        **{k: sum(c[k] for c in calls.values())
           for k in ("table_s", "upload_s", "device_s", "points_s")},
        "peak_mem_bytes": torch.cuda.max_memory_allocated() - held,
        "held_mem_bytes": held,
        "launches": {k: v for k, v in launches.items() if v}})
    m = params.domain_size
    # a table a group: its ladder and its levels launches (4 at c = 8)
    want = {"fixed_base_ladder_g1": 1, "fixed_base_ladder_g2": 1,
            "fixed_base_levels_g1": 4, "fixed_base_levels_g2": 4,
            "fixed_base_msm_g1": 6, "fixed_base_msm_g2": 2,
            "to_affine_g1": 6, "to_affine_g2": 2}
    assert result["launches"] == want, result["launches"]
    log(f"setup at 2^{LOG2N} on the card: {wall:.2f}s (qap "
        f"{st['qap_evals_s']:.2f}s), peak {result['peak_mem_bytes']} B over "
        f"{held} B held; "
        f"{ {k: round(c['wall_s'], 3) for k, c in calls.items()} }")

    # every query exact: the scalars again, from the QAP's values
    t0 = time.time()
    u, v, w = S.qap_evals_at_tau(
        r1cs, tox["tau"], Domain.for_constraints(r1cs.num_constraints + ni))
    gamma_inv, delta_inv = batch_inverse([tox["gamma"], tox["delta"]])
    ic_s = [(tox["beta"] * u[i] + tox["alpha"] * v[i] + w[i]) * gamma_inv
            % R for i in range(ni)]
    l_s = [(tox["beta"] * u[i] + tox["alpha"] * v[i] + w[i]) * delta_inv
           % R for i in range(ni, nv)]
    h_s, p = [], (pow(tox["tau"], m, R) - 1) * delta_inv % R
    for _ in range(m - 1):
        h_s.append(p)
        p = p * tox["tau"] % R
    rng = random.Random(SEED + 2)
    for name, pts, scs in (("ic", params.vk.ic, ic_s), ("l", params.l, l_s),
                           ("a", params.a, u), ("b_g1", params.b_g1, v),
                           ("h", params.h, h_s)):
        assert len(pts) == len(scs), name
        rlc_check(eng, rng, pts, scs, False)
    rlc_check(eng, rng, params.b_g2, v, True)
    vk = params.vk
    assert [vk.alpha_g1, vk.beta_g1, vk.delta_g1] == [
        g1_mul(G1_GEN, tox[k]) for k in ("alpha", "beta", "delta")]
    assert [vk.beta_g2, vk.gamma_g2, vk.delta_g2] == [
        g2_mul(G2_GEN, tox[k]) for k in ("beta", "gamma", "delta")]
    nulls = {k: sum(p is None for p in getattr(params, k))
             for k in ("a", "b_g1", "l", "h", "b_g2")}
    assert nulls == {"a": sum(x == 0 for x in u),
                     "b_g1": sum(x == 0 for x in v), "l": 0, "h": 0,
                     "b_g2": sum(x == 0 for x in v)}, nulls
    result["rlc_check_s"] = time.time() - t0
    result["infinity_points"] = nulls

    # the pk, and a proof from it on the card
    work = tempfile.mkdtemp(prefix="za_setup_")
    env = {k: os.environ.get(k) for k in ("ZA_WTRACE", "ZA_DEVCACHE")}
    try:
        pk = os.path.join(work, "proving.key")
        t0 = time.time()
        with open(pk, "wb") as f:
            fmt.write_pk(f, circuit["asts"], circuit["cons"],
                         circuit["removed"], params,
                         densities=r1cs.densities())
        result["pk_write_s"] = time.time() - t0
        result["pk_bytes"] = os.path.getsize(pk)
        # one prove: no trace or table cache kept beside the pk
        os.environ.update(ZA_WTRACE="0", ZA_DEVCACHE="0")
        rs, t = (13, 17), {}
        pj = helper.prove(pk, [("main.x", FS(CLI_X))], engine=GpuEngine(),
                          deterministic_rs=rs, timings=t)
        result["prove_wall_s"] = t["wall_s"]
        assert os.listdir(work) == ["proving.key"]
    finally:
        for k, val in env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        shutil.rmtree(work, ignore_errors=True)
    proof, pub = fmt.proof_from_json(pj)
    assert pub == z[1:ni], "public inputs"
    # A, B, C from the toxic waste: A(tau) = sum z_i u_i(tau) (with the
    # input rows), h(tau) Z(tau) = A(tau) B(tau) - C(tau)
    r_, s_ = rs
    At, Bt, Ct = (sum(a * b for a, b in zip(z, q)) % R for q in (u, v, w))
    pa = (tox["alpha"] + At + r_ * tox["delta"]) % R
    pb = (tox["beta"] + Bt + s_ * tox["delta"]) % R
    lsum = sum(zi * (tox["beta"] * u[i] + tox["alpha"] * v[i] + w[i])
               for i, zi in enumerate(z) if i >= ni)
    pc = ((lsum + At * Bt - Ct) * delta_inv + s_ * pa + r_ * pb
          - r_ * s_ * tox["delta"]) % R
    assert proof.a == g1_mul(G1_GEN, pa), "proof A"
    assert proof.b == g2_mul(G2_GEN, pb), "proof B"
    assert proof.c == g1_mul(G1_GEN, pc), "proof C"
    assert verify_proof(params.vk, proof, z[1:ni]), "pairing check"
    log(f"proof from the card's 2^{LOG2N} pk verifies "
        f"(helper wall {t['wall_s']:.1f}s)")

    # the host setup, extrapolated from a sample of each group
    sample = [rng.randrange(R) for _ in range(HOST_SAMPLE)]
    t0 = time.time()
    for sc in sample:
        g1_mul(G1_GEN, sc)
    g1_s = (time.time() - t0) / HOST_SAMPLE
    t0 = time.time()
    for sc in sample:
        g2_mul(G2_GEN, sc)
    g2_s = (time.time() - t0) / HOST_SAMPLE
    n_g1 = sum(c["n"] for k, c in calls.items() if k != "b_g2"
               and k != "vk_g2")
    n_g2 = calls["b_g2"]["n"] + calls["vk_g2"]["n"]
    result["host_setup_extrapolated"] = {
        "g1_mul_s": g1_s, "g2_mul_s": g2_s, "g1_points": n_g1,
        "g2_points": n_g2, "sample": HOST_SAMPLE,
        "setup_s": g1_s * n_g1 + g2_s * n_g2 + st["qap_evals_s"]
        + st["scalars_s"]}

    # the h query of 2^20 constraints: its peak, a few points checked
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    big = [rng.randrange(R) for _ in range(H_2_20)]
    t0 = time.time()
    pts = eng.fixed_base_g1(big)
    result["h_2^20"] = {
        "n": H_2_20, "wall_s": time.time() - t0, **eng.fixed_base_info,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() - held}
    for i in (0, H_2_20 // 2, H_2_20 - 1):
        assert pts[i] == g1_mul(G1_GEN, big[i]), f"h at 2^20, point {i}"
    del pts, big
    result["phase_s"] = time.time() - t_phase
    log(f"setup phase: {result['phase_s']:.1f}s, host setup extrapolated "
        f"{result['host_setup_extrapolated']['setup_s']:.1f}s; h at 2^20: "
        f"{result['h_2^20']}")
    return result, launches, {"h_s": h_s, "v": v, "launches": launches}


# -- phase 4e: several ranks (engine/mesh.py, engine/dist.py) ------------------------

#: seconds a mesh phase may take before its ranks are stopped
MESH_TIMEOUT = 420
#: the kernels every rank of a sharded prove launches, by route
MESH_KERNELS = {
    "tree": ("tree_level0_g1", "tree_level_g1", "tree_level0_g2",
             "tree_level_g2", "ec_carry_g1", "ec_carry_g2"),
    "dense": ("dense_window_sums_g1", "dense_window_sums_g2"),
    "all": ("ec_fold_g1", "ec_fold_g2", "horner_g1", "horner_g2",
            "r1cs_matvec_fr", "ntt_prefix_fr", "ntt_twiddle_fr",
            "ntt_prefix_fr.scale_in", "ntt_prefix_fr.combine",
            "ntt_prefix_fr.scale_out")}
SETUP_MESH_N = 510     # the setup --mesh check's chain


def mesh_rank(rank: int, D: int, backend: str, root: str, job: str,
              out: str, rdv: str) -> None:
    """One rank of a mesh phase (a spawned process): joins the group,
    proves the job's inputs with GpuEngine(mesh=...) and writes what
    mesh_prove returns to out."""
    sys.path.insert(0, root)
    import torch

    torch.set_num_threads(2)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    torch.distributed.init_process_group(
        backend, init_method=rdv, world_size=D, rank=rank,
        timeout=timedelta(seconds=MESH_TIMEOUT))
    try:
        res = mesh_prove(torch, job)
    finally:
        torch.distributed.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)


def mesh_prove(torch, job: str) -> dict:
    """This rank's sharded prove of the job's inputs: staging and the
    first prove with every launch counted (and the prove's launches
    alone), the collectives of that prove, then the device compute (h(x)
    and the MSMs, CUDA events, one warm-up, median of 3), h(x) checked to
    run no torch field product, each MSM's points."""
    from za_tpu_torch.engine import _build, mesh as MESH, ntt as NTT
    from za_tpu_torch.engine.engine import GpuEngine
    from za_tpu_torch.groth16.domain import Domain
    from za_tpu_torch.groth16.prove import prove

    t_wall = time.time()
    with open(job, "rb") as f:
        j = pickle.load(f)
    load_s = time.time() - t_wall
    params, r1cs, z = j["params"], j["r1cs"], j["z"]
    mesh = MESH.make_mesh(torch.distributed.get_world_size())
    mesh.timed = True
    eng = GpuEngine(mesh=mesh)
    timer = Timer(torch)
    _build.reset_launches()
    modes0 = dict(NTT.PREFIX_LAUNCHES)
    staged, stage_s = timer(lambda: eng.stage_params(params, r1cs))
    staging = launch_counts()
    _build.reset_launches()
    mesh.stats = {}
    proof, prove_s = timer(lambda: prove(params, r1cs, z, r=j["r"],
                                         s=j["s"], engine=eng))
    in_prove = launch_counts()
    launches = {k: v + staging[k] for k, v in in_prove.items()}
    launches.update({f"ntt_prefix_fr.{k}": v - modes0.get(k, 0)
                     for k, v in NTT.PREFIX_LAUNCHES.items()})
    collectives = {k: {"calls": c, "bytes": b, "s": sec}
                   for k, (c, b, sec) in mesh.stats.items()}
    z_l = eng.witness_limbs_dev(z)
    domain = Domain(params.domain_size)
    out = {}

    def compute():
        st = {}
        out["h"], st["h"] = timer(lambda: eng.h_coeffs_limbs(r1cs, z_l,
                                                             domain))
        for tag, tabs, scs in msm_queries(staged, z_l, out["h"],
                                          r1cs.num_inputs):
            fn = eng.msm_g2_many if tag == "b2" else eng.msm_g1_many
            out[tag], st[f"msm_{tag}"] = timer(lambda: fn(tabs, scs))
        return st

    stages, totals, warm = median_runs(compute)
    torch_ops = h_torch_ops(eng, r1cs, z_l, domain)
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "route": "tree" if "g1abl" in staged else "dense",
            "proof": proof, "msms": {k: v for k, v in out.items()
                                     if k != "h"},
            "launches": launches, "launches_in_prove": in_prove,
            "h_torch_ops": torch_ops, "load_s": load_s, "stage_s": stage_s,
            "prove_s": prove_s, "collectives_prove": collectives,
            "device_compute_s": statistics.median(totals),
            "stages_s": stages, "runs_s": totals, "warmup_s": warm,
            "layout": {k: ([t.chunk_cols, t.chunks] if hasattr(t, "chunks")
                           else [t.n]) for k, t in staged.items()},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "wall_s": time.time() - t_wall}


def run_ranks(target, D: int, args_of) -> float:
    """Spawn D ranks of target(rank, *args_of(rank)); wait up to
    MESH_TIMEOUT, stopping every rank when one fails -> seconds."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args_of(r)))
             for r in range(D)]
    t0 = time.time()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(MESH_TIMEOUT - (time.time() - t0), 1))
            if p.exitcode != 0:
                raise AssertionError(
                    f"rank {procs.index(p)} of {D} ended with "
                    f"{p.exitcode} (None: still running at "
                    f"{MESH_TIMEOUT} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    return time.time() - t0


def mesh_phase(tag: str, ctx: dict, D: int, backend: str, root: str,
               tmp: str) -> tuple:
    """A path's prove by D ranks: its inputs written once for them, the
    ranks spawned, each rank's proof held equal to the one-card proof of
    the same inputs and r, s and to the pairing check, every rank's MSM
    points equal, each rank's launches checked (the route's kernels,
    h(x)'s, the cross-rank reduce's ec_add: log2 D a MSM) and its h(x)
    free of torch field products -> (the phase's line, per-rank
    launches)."""
    import copy
    import dataclasses

    t0 = time.time()
    inp = ctx["inp"]
    r1cs = copy.copy(inp["r1cs"])
    r1cs.__dict__.pop("_torch_csr", None)   # the parent's device CSRs
    job = os.path.join(tmp, f"{tag}.pkl")
    with open(job, "wb") as f:
        pickle.dump({"params": dataclasses.replace(inp["params"]),
                     "r1cs": r1cs, "z": inp["z"], "r": inp["r"],
                     "s": inp["s"]}, f, protocol=pickle.HIGHEST_PROTOCOL)
    job_s = time.time() - t0
    outs = [os.path.join(tmp, f"{tag}.{r}.pkl") for r in range(D)]
    rdv = "file://" + os.path.join(tmp, f"{tag}.rdv")
    ranks_s = run_ranks(mesh_rank, D, lambda r: (D, backend, root, job,
                                                 outs[r], rdv))
    res = []
    for o in outs:
        with open(o, "rb") as f:
            res.append(pickle.load(f))
    os.remove(job)
    route = res[0]["route"]
    for r in res:
        assert r["proof"] == ctx["proof"], f"{tag} rank {r['rank']}: proof"
        assert r["msms"] == res[0]["msms"], f"{tag} rank {r['rank']}: MSMs"
        want = MESH_KERNELS[route] + MESH_KERNELS["all"]
        idle = [k for k in want if r["launches"].get(k, 0) == 0]
        assert not idle, f"{tag} rank {r['rank']} launched none of {idle}"
        adds = {"ec_add_g1": (2 if route == "tree" else 1),
                "ec_add_g2": 1}
        got = {k: r["launches_in_prove"][k] for k in adds}
        levels = D.bit_length() - 1
        assert got == {k: v * levels for k, v in adds.items()}, \
            f"{tag} rank {r['rank']}: the reduce's ec_add launches {got}"
        assert not any(r["h_torch_ops"].values()), \
            f"{tag} rank {r['rank']}: h(x) ran tensor code {r['h_torch_ops']}"
    assert pairing_accepts(inp, res[0]["proof"], *ctx["pabc"]), \
        f"{tag}: pairing check"
    line = {"ranks": D, "backend": backend, "route": route,
            "inputs_write_s": job_s, "ranks_s": ranks_s,
            "wall_s": time.time() - t0, "pairing_ok": True,
            "per_rank": [{k: r[k] for k in (
                "rank", "load_s", "stage_s", "prove_s", "device_compute_s",
                "stages_s", "runs_s", "warmup_s", "collectives_prove",
                "h_torch_ops", "launches_in_prove", "layout",
                "peak_mem_bytes", "wall_s")} for r in res]}
    log(f"{tag}: {D} ranks over {backend}, proofs equal the one-card "
        f"proof, pairing ok; ranks {ranks_s:.1f}s, device compute "
        f"{[round(r['device_compute_s'], 4) for r in res]}, collectives "
        f"{res[0]['collectives_prove']}")
    return line, [r["launches"] for r in res]


def mesh_setup_rank(rank: int, D: int, root: str, work: str, out: str,
                    port: int) -> None:
    """One rank of `za setup --mesh D` (a spawned process): joins a gloo
    group at 127.0.0.1:port (ranks sharing one card ask for gloo), sets
    ZA_DIST to that group, and runs the CLI in work with fixed toxic
    waste; writes its exit code and launches to out."""
    sys.path.insert(0, root)
    import functools

    import torch

    torch.set_num_threads(2)
    addr = f"127.0.0.1:{port}"
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{addr}", world_size=D, rank=rank,
        timeout=timedelta(seconds=MESH_TIMEOUT))
    os.environ["ZA_DIST"] = f"{addr},{D},{rank}"
    from za_tpu_torch import cli
    from za_tpu_torch.engine import _build
    from za_tpu_torch.groth16 import helper

    helper.generate_parameters = functools.partial(
        helper.generate_parameters, **SETUP_TOXIC)
    os.chdir(work)
    _build.reset_launches()
    try:
        rc = cli.main(["setup", "--mesh", str(D), "--verifiertype", "json"])
    finally:
        torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"rc": rc, "launches": launch_counts()}, f)


def mesh_setup(torch, root: str, tmp: str, D: int = 2) -> tuple:
    """`za setup --mesh D` at SETUP_MESH_N constraints (rank 0 sets up on
    its card, the other ranks wait) against `za setup` in this process,
    both with fixed toxic waste: the same pk bytes and verifier; then
    `za prove --mesh D` from that pk in a process of its own: D ranks
    over NCCL where the machine has D cards (the proof verifies), else
    refused -> (the check's line, rank 0's launches)."""
    import functools

    from za_tpu_torch import cli
    from za_tpu_torch.engine.dist import free_port
    from za_tpu_torch.groth16 import helper

    t0 = time.time()
    dirs = {k: os.path.join(tmp, f"setup_{k}") for k in ("one", "mesh")}
    for d in dirs.values():
        os.makedirs(d)
        with open(os.path.join(d, "circuit.za"), "w") as f:
            f.write(CHAIN_ZA % SETUP_MESH_N)
    outs = [os.path.join(tmp, f"setup_mesh.{r}.json") for r in range(D)]
    port = free_port()
    ranks_s = run_ranks(mesh_setup_rank, D, lambda r: (
        D, root, dirs["mesh"], outs[r], port))
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    assert [r["rc"] for r in res] == [0] * D, f"setup --mesh: {res}"
    orig, cwd = helper.generate_parameters, os.getcwd()
    helper.generate_parameters = functools.partial(orig, **SETUP_TOXIC)
    try:
        os.chdir(dirs["one"])
        t1 = time.time()
        assert cli.main(["setup", "--verifiertype", "json"]) == 0
        one_s = time.time() - t1
    finally:
        helper.generate_parameters = orig
        os.chdir(cwd)
    read = {k: {f: open(os.path.join(d, f), "rb").read()
                for f in ("proving.key", "verifier.json")}
            for k, d in dirs.items()}
    assert read["mesh"] == read["one"], \
        "setup --mesh wrote another pk or verifier than the setup without"
    assert not any(res[r]["launches"][k] for r in range(1, D)
                   for k in res[r]["launches"]), \
        "a rank other than 0 launched kernels in the setup"
    # `za prove --mesh D` from that pk starts D local ranks, one a card
    # over NCCL: with fewer cards it must refuse, and write no proof
    with open(os.path.join(dirs["mesh"], "input.json"), "w") as f:
        json.dump({"x": str(CLI_X)}, f)
    t1 = time.time()
    p = subprocess.run([sys.executable, "-m", "za_tpu_torch.cli", "prove",
                        "--mesh", str(D)], cwd=dirs["mesh"],
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=MESH_TIMEOUT)
    cards = torch.cuda.device_count()
    proof = os.path.join(dirs["mesh"], "proof.json")
    if cards >= D:
        assert p.returncode == 0, f"za prove --mesh {D}:\n{p.stderr[-4000:]}"
        v = subprocess.run([sys.executable, "-m", "za_tpu_torch.cli",
                            "verify"], cwd=dirs["mesh"],
                           env=dict(os.environ, PYTHONPATH=root),
                           capture_output=True, text=True, timeout=600)
        assert v.stdout.strip() == "OK", f"za verify: {v.stdout!r}"
    else:
        assert p.returncode == 1 and not os.path.exists(proof) and \
            f"mesh needs {D} devices, have {cards}" in p.stderr, \
            f"za prove --mesh {D} on {cards} card(s): rc {p.returncode}" \
            f"\n{p.stderr[-4000:]}"
    line = {"ranks": D, "backend": "gloo", "constraints": SETUP_MESH_N,
            "pk_bytes": len(read["one"]["proving.key"]),
            "pk_equal": True, "ranks_s": ranks_s, "one_card_s": one_s,
            "cli_prove_mesh": ("proved" if cards >= D else
                               "refused: one rank a card"),
            "cli_prove_mesh_s": time.time() - t1,
            "wall_s": time.time() - t0}
    log(f"setup --mesh {D} at {SETUP_MESH_N} constraints: the same "
        f"{line['pk_bytes']} pk bytes as the setup without ({ranks_s:.1f}s "
        f"with the ranks' start, {one_s:.1f}s in this process)")
    return line, res[0]["launches"]


def mesh_phases(torch, root: str, tctx: dict, dctx: dict, card: str):
    """The several-rank phases: the 2^17 chain (tree) by 4 ranks and the
    2^13 chain (dense) by 2, sharing the one card over gloo; the 2^17
    chain by a one-rank NCCL group (and by 2 ranks over NCCL on two cards
    where there are two); `za setup --mesh 2` -> (the phases' line,
    {path: launches})."""
    tmp = tempfile.mkdtemp(prefix="za_mesh_")
    t0 = time.time()
    phases, per_path = {}, {}
    runs = [(f"mesh4_2^{LOG2N}", tctx, 4, "gloo"),
            (f"mesh2_2^{LOG2N_DENSE}", dctx, 2, "gloo"),
            (f"nccl1_2^{LOG2N}", tctx, 1, "nccl")]
    if torch.cuda.device_count() >= 2:
        runs.append((f"nccl2_2^{LOG2N}", tctx, 2, "nccl"))
    try:
        for tag, ctx, D, backend in runs:
            phases[tag], launches = mesh_phase(tag, ctx, D, backend, root,
                                               tmp)
            per_path.update({f"{tag}.rank{r}": v
                             for r, v in enumerate(launches)})
        phases["setup_mesh2_510"], per_path["setup_mesh2_510"] = \
            mesh_setup(torch, root, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = {"metric": "mesh_phases", "phases": phases,
            "shared_card": torch.cuda.device_count() < 2,
            "note": ("ranks over gloo share one card and copy each "
                     "collective through the host; a one-rank NCCL group "
                     "moves device tensors on one card: none of these "
                     "runs is a scaling number"),
            "phases_s": time.time() - t0,
            "device": torch.cuda.get_device_name(0), "card": card}
    return line, per_path


# -- phase 5: kernels against their plain versions ----------------------------------


def rand_fq(torch, shape, gen):
    """Random field values as l32 (8, *shape): the top 16-bit limb is
    below 0x3064, the top limb of both q and r, so every value is
    canonical mod q and mod r."""
    from za_tpu_torch.engine import field as F

    limbs = torch.randint(0, 1 << 16, (16,) + tuple(shape), generator=gen,
                          dtype=torch.int64, device="cuda")
    limbs[15] = torch.randint(0, 0x3064, tuple(shape), generator=gen,
                              dtype=torch.int64, device="cuda")
    return F.pack(limbs)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, muls: int):
    tb = bytes_moved / HBM_BYTES_PER_S
    to = muls * MADS_PER_MUL / INT32_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def dit_muls(S: int, m: int) -> int:
    """Multiplications of the DIT stages 2..m of a length-S transform,
    per lane: a butterfly whose twiddle is w^0 = 1 needs none, so stage
    h (half-length) of each m-row segment multiplies m/2 - m/(2h)."""
    return S // m * (m // 2 * (m.bit_length() - 1) - (m - 1))


def ptxas_usage(log_text: str, prefix: str) -> dict:
    """{"regs", "spill_bytes"} of the entry function whose mangled name
    starts with prefix, from nvcc's -Xptxas -v log: its registers and
    the bytes of its spill stores and loads per thread."""
    import re

    for part in log_text.split("Compiling entry function '")[1:]:
        fn = part.split("'", 1)[0]
        if not fn.startswith(prefix):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"Function properties for " + re.escape(fn)
                          + r"\s+\d+ bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", part)
        assert regs and spill, f"ptxas log: no usage for {fn}"
        return {"regs": int(regs.group(1)),
                "spill_bytes": int(spill.group(1)) + int(spill.group(2))}
    raise AssertionError(f"ptxas log: no entry function {prefix}...")


def device_ms(torch, fn, reps: int = 5) -> float:
    """Device ms of fn()'s launches, median of reps calls after a
    warm-up: each call is queued behind a ~2 ms sleep kernel, so its
    launches reach the card back to back and the host's time to issue
    them does not count."""
    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)   # cycles
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def issue_ms(torch, fn, reps: int = 5) -> float:
    """Mean ms of reps calls of fn() back to back after a warm-up, the
    host's time to issue them included."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def h_inline(torch, eng, r1cs, z_l, domain, reps: int = 5) -> dict:
    """One h_coeffs_limbs (the matvec, then the three transforms) with
    every kernel launch between CUDA events, queued behind a sleep
    kernel so that the host has issued them all before the card reaches
    them (launch_times) -> {kernel: device ms of its launches in h, "h":
    h's span}, medians of reps after a warm-up."""
    runs = []
    for _ in range(reps + 1):
        eng._sat_legs = None            # the matvec runs inside h
        seq, span = launch_times(
            torch, lambda: eng.h_coeffs_limbs(r1cs, z_l, domain), 4_000_000)
        run = {"h": span}
        for name, ms in seq:
            run[name] = run.get(name, 0.0) + ms
        runs.append(run)
    return {k: statistics.median(r[k] for r in runs[1:]) for k in runs[1]}


def launch_times(torch, fn, sleep_cycles: int):
    """fn() with every kernel launch between CUDA events, queued behind a
    sleep kernel of sleep_cycles -> ([(kernel, device ms)] in launch
    order, fn's span in ms)."""
    from za_tpu_torch.engine import _build

    call = _build.Kernel.__call__
    marks = []

    def timed(self, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call(self, *args)
        b.record()
        marks.append((self.name, a, b))

    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    _build.Kernel.__call__ = timed
    try:
        s.record()
        fn()
        e.record()
    finally:
        _build.Kernel.__call__ = call
    torch.cuda.synchronize()
    return [(n, a.elapsed_time(b)) for n, a, b in marks], s.elapsed_time(e)


def msm_launch_split(torch, eng, staged, z_l, h, ni, reps: int = 3) -> dict:
    """Each tree MSM of one prove with its launches timed in place
    (launch_times behind a ~25 ms sleep, so the host has queued them) ->
    {tag: {kernel: ms summed, "chunk_first" / "chunk_last" /
    "chunk_mean": a chunk's level 0 and levels, "chunks", "span"}},
    medians of reps after a warm-up."""
    from za_tpu_torch.engine import cuda_tree as CT

    out = {}
    for tag, tabs, scal in msm_queries(staged, z_l, h, ni):
        sc = eng._scalars(tabs, scal)
        runs = []
        for _ in range(reps + 1):
            seq, span = launch_times(torch, lambda: CT.msm_tree(tabs, sc),
                                     50_000_000)
            chunks, run = [], {"span": span}
            for name, ms in seq:
                if name.startswith("tree_level0_"):
                    chunks.append(0.0)
                if name.startswith(("tree_level0_", "tree_level_")):
                    chunks[-1] += ms
                else:
                    run[name] = run.get(name, 0.0) + ms
            run.update({"chunk_first": chunks[0], "chunk_last": chunks[-1],
                        "chunk_mean": statistics.mean(chunks),
                        "chunks": len(chunks)})
            runs.append(run)
        out[tag] = {k: statistics.median(r[k] for r in runs[1:])
                    for k in runs[1]}
        log(f"{tag} in place: {out[tag]}")
    return out


def compare(torch, name, kern, plain, args, reps: int = 3):
    """Run kernel and plain version on the same inputs; exact check;
    CUDA-event times: the kernel's device time (device_ms) and the mean
    of reps calls back to back after a warm-up, host issue included
    ("issue_ms"); the plain version once."""
    out_k = kern(*args)
    issue = issue_ms(torch, lambda: kern(*args), reps)
    dev = device_ms(torch, lambda: kern(*args))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out_p = plain(*args)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    err = 0
    for k, p in zip(out_k, out_p):
        if k.dtype == torch.bool:
            err = max(err, int((k != p).sum()))
        else:
            d = (k.to(torch.int64) & 0xFFFFFFFF) - (p.to(torch.int64) & 0xFFFFFFFF)
            err = max(err, int(d.abs().max()))
    assert err == 0, f"{name}: kernel differs from its plain version ({err})"
    return out_k, Times(dev, issue), plain_ms, err


class Times(float):
    """A kernel's device ms (the float) with its back-to-back issue mean
    beside it (.issue)."""

    def __new__(cls, dev: float, issue: float):
        t = super().__new__(cls, dev)
        t.issue = issue
        return t


def affine_blocks(n: int, is_g2: bool) -> int:
    """The blocks to_affine_g1/_g2 launch for n points (its one-wave
    split, csrc/ec.cu to_affine_blocks), each inverting once."""
    import ctypes
    from za_tpu_torch.engine import _build

    fn = _build.library("ec").to_affine_blocks
    fn.restype = ctypes.c_long
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    blocks = fn(n, int(is_g2))
    assert blocks > 0, f"to_affine_blocks: CUDA error {-blocks}"
    return blocks


def staging_edge_checks(torch, gen) -> None:
    """ec_add and to_affine of both groups, exact against their plain
    versions, at ragged n (a multiple of neither 128 nor a block's J
    128 points) with every seventh Z zero, in G2 Z with one component
    zero, and doublings among the adds: the blocks' partial ends, the
    zero keys and the norm's cases."""
    from za_tpu_torch.engine import ec

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    cases = {False: ((1000, 196608 - 77), (1000, 1572864 - 77)),
             True: ((1, 1000, (1 << 14) - 77, (1 << 15) - 77),
                    (1, 1000, (1 << 18) - 77))}
    for is_g2, (add_ns, aff_ns) in cases.items():
        E = (2,) if is_g2 else ()
        for n in sorted(set(add_ns + aff_ns)):
            p = [rand_fq(torch, E + (n,), gen) for _ in range(6)]
            for z, off in ((p[2], 0), (p[5], 3)):
                z[..., off::7] = 0
                if is_g2:
                    z[:, 0, off + 1::7] = 0
                    z[:, 1, off + 2::7] = 0
            for a, b in zip(p[:3], p[3:]):           # doublings
                b[..., 5::11] = a[..., 5::11]
            if n in add_ns:
                assert same(ec.ec_add(p[:3], p[3:], is_g2),
                            ec.ec_add_plain(p[:3], p[3:], is_g2)), (
                    f"ec_add g2={is_g2} n={n}")
            if n in aff_ns:
                assert same(ec.to_affine(*p[:3], is_g2),
                            ec.to_affine_plain(*p[:3], is_g2)), (
                    f"to_affine g2={is_g2} n={n}")
    log("staging kernels exact at ragged n with zero Z")


def kernels_vs_plain(torch, tctx, dctx, bctx, launches, sctx):
    """tctx: the tree path's engine and staged tables (2^17); dctx: the
    dense path's, default and fused style (2^13); bctx: the 2^20 path's
    domain and launches; sctx: the 2^17 setup's h and b_g2 scalars and
    launches."""
    from za_tpu_torch.engine import _build, cuda_tree as CT, ec, msm as MSM
    from za_tpu_torch.engine import field as F, msm_dense as MD
    from za_tpu_torch.engine import msm_tree as MT, ntt as NTT, r1cs as RC

    eng, staged, z_l = tctx["eng"], tctx["staged"], tctx["z_l"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []

    def row(name, source, replaces, shape, ms, plain_ms, err, bmoved, muls):
        b_ms, by = bound(bmoved, muls)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": float(ms), "device_ms": float(ms),
            "issue_ms": getattr(ms, "issue", None), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": shape,
        })
        log(f"{name} [{shape}]: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.3f} ms by {by}), launches {launches[name]}")

    tree_src = "za_tpu_torch/csrc/tree.cu"
    tree_log = (_build.build_dir() / "tree.log").read_text()
    for is_g2, tabs, scal, refs in (
        (False, staged["g1abl"], [z_l, z_l, z_l[:, 2:]],
         ("za_tpu/engine/pallas_tree.py:534", "za_tpu/engine/pallas_tree.py:303")),
        (True, staged["b_g2x"], [z_l],
         ("za_tpu/engine/pallas_tree.py:1169", "za_tpu/engine/pallas_tree.py:965")),
    ):
        g = "g2" if is_g2 else "g1"
        fmul = 3 if is_g2 else 1     # Fq multiplications per field mul
        d = CT.window_digits(tabs, eng._scalars(tabs, scal))[0]
        args = (tabs.tx[0], tabs.ty[0], d, is_g2)
        (x, y, inf), ms, pms, err = compare(
            torch, f"tree_level0_{g}", CT.tree_level0, MT.tree_level0_plain,
            args)
        h = d.shape[-1] // 2           # pairs with both digits nonzero
        live = int(((d[..., :h] != 0) & (d[..., h:] != 0)).sum())
        row(f"tree_level0_{g}", tree_src, refs[0],
            f"2^{LOG2N} chunk M={tabs.m} S={tabs.chunk_cols}", ms, pms, err,
            nbytes(tabs.tx[0], tabs.ty[0], d, x, y, inf), 6 * fmul * live)
        rows[-1].update(ptxas_usage(tree_log, KERNEL_FN[f"tree_level0_{g}"]))
        # every level of the chunk, n = S/2 points down to 2 TAIL; the
        # row is the widest, per_level_ms all of them
        levels = []
        while x.shape[-1] > CT.TAIL:
            (x2, y2, inf2), ms, pms, err = compare(
                torch, f"tree_level_{g}", CT.tree_level, MT.tree_level_plain,
                (x, y, inf, is_g2), reps=10)
            h = x.shape[-1] // 2
            live = int((~(inf[..., :h] | inf[..., h:])).sum())
            levels.append({"n": x.shape[-1], "ms": ms, "plain_ms": pms,
                           "err": err, "bytes": nbytes(x, y, inf, x2, y2, inf2),
                           "muls": 6 * fmul * live})
            x, y, inf = x2, y2, inf2
        top = levels[0]
        row(f"tree_level_{g}", tree_src, refs[1],
            f"2^{LOG2N} M={tabs.m} n={top['n']}", top["ms"],
            top["plain_ms"], top["err"], top["bytes"], top["muls"])
        rows[-1].update(ptxas_usage(tree_log, KERNEL_FN[f"tree_level_{g}"]))
        rows[-1]["per_level_ms"] = [
            {"n": lv["n"], "ms": lv["ms"],
             "bound_ms": bound(lv["bytes"], lv["muls"])[0]} for lv in levels]
        log(f"tree_level_{g} per level: {rows[-1]['per_level_ms']}")

    # the dense window sums at the 2^13 shapes, both radices
    dense_src = "za_tpu_torch/csrc/dense.cu"
    dense_log = (_build.build_dir() / "dense.log").read_text()
    deng, dz, dh = dctx["eng"], dctx["z_l"], dctx["h"]
    horner_in = []   # (is_g2, radix, window sums) at the dense shapes
    for st in (dctx["staged"], dctx["fstaged"]):
        for is_g2, tabs, scal in (
                (False, st["g1x4"], [dz, dz, dz[:, 2:], dh]),
                (True, st["b_g2x"], [dz])):
            g = "g2" if is_g2 else "g1"
            name, ref = (("dense_window_sums", "pallas_msm_rns.py:374")
                         if tabs.radix == 16 else
                         ("dense4_window_sums", "pallas_msm.py:102"))
            d = MD.digits(deng._scalars(tabs, scal), tabs.radix)
            L, S = MD.plan(tabs)
            outs, ms, pms, err = compare(
                torch, f"{name}_{g}", MD.dense_window_sums,
                MD.dense_window_sums_plain, (tabs, d, L, S), reps=5)
            # one complete add per nonzero digit, S - 1 a lane to fold
            # the segments
            W = d.shape[0]
            row(f"{name}_{g}", dense_src, f"za_tpu/engine/{ref}",
                f"2^{LOG2N_DENSE} M={tabs.m} n={tabs.n} L={L} S={S}", ms,
                pms, err, nbytes(tabs.x, tabs.y, tabs.z, d, *outs),
                ADD_MULS[is_g2] * (int((d != 0).sum())
                                   + tabs.m * W * L * (S - 1)))
            rows[-1].update(ptxas_usage(dense_log,
                                        KERNEL_FN[f"{name}_{g}"]))
            # a lane's chain: its segment's points, then log2 S fold adds
            chain = tabs.n / (L * S) + (S.bit_length() - 1)
            rows[-1].update({
                "warps_per_sm": MD.resident_blocks(
                    tabs.radix, is_g2, d.device) * MD.DTB // 32,
                "adds_a_thread": tabs.n / (L * S),
                "us_per_add": ms * 1e3 / chain})
            if tabs.radix == 4 or not is_g2:  # radix-16 G2: the tree's shape
                horner_in.append((is_g2, tabs.radix,
                                  MSM.lane_fold(outs, is_g2)))

    # Horner at radix 16 on the tree path's window sums (M = 3 and 1),
    # then on the dense path's (g1x4 at radix 16, both at radix 4)
    ec_src = "za_tpu_torch/csrc/ec.cu"
    ec_log = (_build.build_dir() / "ec.log").read_text()
    for is_g2, tabs, scal in ((True, staged["b_g2x"], [z_l]),
                              (False, staged["g1abl"],
                               [z_l, z_l, z_l[:, 2:]])):
        wsum = CT.tree_window_sums(tabs, eng._scalars(tabs, scal))
        horner_in.insert(0, (is_g2, 16, wsum))
    for is_g2, radix, wsum in horner_in:
        g = "g2" if is_g2 else "g1"
        bits = MD.BITS[radix]
        M, W = wsum[0].shape[-2:]
        outs, ms, pms, err = compare(
            torch, f"horner_{g}",
            lambda *a: MSM.horner_windows(a, is_g2, bits),
            lambda *a: MSM.horner_windows_plain(a, is_g2, bits), wsum)
        row(f"horner_{g}", ec_src, "za_tpu/engine/msm.py:698",
            f"radix {radix} M={M} W={W}", ms, pms, err,
            nbytes(*wsum, *outs), ADD_MULS[is_g2] * (bits + 1) * W * M)
        # one MSM's chain: bits doublings and one add per window
        rows[-1]["us_per_add"] = ms * 1e3 / ((bits + 1) * W)
        rows[-1].update(ptxas_usage(ec_log, KERNEL_FN[f"horner_{g}"]))
    # the staged add's latency, from the radix-16 Horner rows of this run
    warp_us = {}
    for r in rows:
        if r["name"].startswith("horner_"):
            warp_us.setdefault(r["name"][-2:], r["us_per_add"])
    rows.extend(tail_rows(torch, tctx, dctx, gen, launches, warp_us, ec_log))

    # the four-step's kernels at the 2^17 rung (domain 2^18), the first
    # sub-NTT's shape: 3 legs x n2 rows x n1 lanes
    ntt_src = "za_tpu_torch/csrc/ntt.cu"
    ntt_log = (_build.build_dir() / "ntt.log").read_text()
    dom = eng._domain(1 << (LOG2N + 1))
    fs = dom.fourstep
    x = rand_fq(torch, (3, fs.n2, fs.n1), gen)   # also canonical mod r
    m = NTT.prefix_rows(fs.n2, fs.n1)
    # no mode, then each mode on h(x)'s tables: the coset powers on the
    # 3 legs; the combine of the 3 legs into 1; the store table on 1
    prefix_cases = [
        ("plain", x, {}, 3),
        ("scale_in", x, {"scale_in": dom.coset_pow}, 3),
        ("combine", x, {"combine": True}, 1),
        ("scale_out", x[:, :1].contiguous(), {"scale_out": dom.h_out}, 1)]
    for mode, xin, kw, legs_out in prefix_cases:
        outs, ms, pms, err = compare(
            torch, f"ntt_prefix_fr {mode}",
            lambda a, t: (NTT.ntt_prefix(a, t, m, **kw),),
            lambda a, t: (NTT.ntt_prefix_plain(a, t, m, **kw),),
            (xin, fs.t2_fwd), reps=5)
        tables = [v for v in kw.values() if torch.is_tensor(v)]
        # one product per value for each mode (the combine's a b per
        # output value) beside the butterflies
        extra = 0 if mode == "plain" else legs_out * fs.n2 * fs.n1
        row("ntt_prefix_fr", ntt_src, "za_tpu/engine/pallas_ntt.py:181",
            f"{xin.shape[1]} x {fs.n2} x {fs.n1} -> {legs_out}, m_fuse {m}"
            + ("" if mode == "plain" else f", {mode}"), ms, pms, err,
            nbytes(xin, outs[0], fs.t2_fwd, *tables),
            legs_out * fs.n1 * dit_muls(fs.n2, m) + extra)
        rows[-1]["mode"] = mode
        rows[-1].update(ptxas_usage(ntt_log, KERNEL_FN["ntt_prefix_fr"]))

    # the matvec and the twiddle transpose at each rung: the chain's
    # three legs (A with the input rows, B, C in one launch); the first
    # sub-NTT's output, 3 legs x n2 x n1 (512 x 512 at 2^17, 128 x 128 at
    # 2^13)
    r1cs_log = (_build.build_dir() / "r1cs.log").read_text()
    for log2n, ctx in ((LOG2N, tctx), (LOG2N_DENSE, dctx)):
        r1cs, zl, mm = ctx["r1cs"], ctx["z_l"], ctx["m"]
        csr = RC.r1cs_csr(r1cs, mm, "cuda")
        outs, ms, pms, err = compare(
            torch, "r1cs_matvec_fr", lambda c, z: (RC.matvec(c, z),),
            lambda c, z: (RC.matvec_plain(c, z),), (csr, zl), reps=5)
        nnz = csr.cols.numel()
        # the uploaded (16, nv) int32 witness limbs, read once
        row("r1cs_matvec_fr", "za_tpu_torch/csrc/r1cs.cu",
            "za_tpu/engine/engine.py:1891",
            f"2^{log2n} chain, 3 legs x {mm} rows, {nnz} entries", ms, pms,
            err, nbytes(csr.row_ptr, csr.cols, csr.coeffs, zl, outs[0]),
            nnz)
        rows[-1].update(ptxas_usage(r1cs_log, KERNEL_FN["r1cs_matvec_fr"]))
        tfs = ctx["eng"]._domain(mm).fourstep
        xt = rand_fq(torch, (3, tfs.n2, tfs.n1), gen)
        outs, ms, pms, err = compare(
            torch, "ntt_twiddle_fr", lambda a, w: (NTT.ntt_twiddle(a, w),),
            lambda a, w: (NTT.ntt_twiddle_plain(a, w),),
            (xt, tfs.inter_fwd), reps=5)
        # inter[k2, j1] = w^(k2 j1) is 1 in row 0 and column 0
        row("ntt_twiddle_fr", ntt_src, "za_tpu/engine/ntt_rns.py:276",
            f"2^{log2n} rung, 3 x {tfs.n2} x {tfs.n1}", ms, pms, err,
            nbytes(xt, tfs.inter_fwd, outs[0]),
            3 * (tfs.n2 - 1) * (tfs.n1 - 1))
        rows[-1].update(ptxas_usage(ntt_log, KERNEL_FN["ntt_twiddle_fr"]))

    # the tail kernel at the 2^20 rung's sub-NTT tails (domain 2^21): (a)
    # the first sub-NTT of a 3-leg transform, (b) the second, (c) the
    # coset iNTT's second with the store mode
    dom = bctx["dom"]
    fs = dom.fourstep
    for tag, B, S, L, tw, table in (
            ("a", 3, fs.n2, fs.n1, fs.t2_fwd, None),
            ("b", 3, fs.n1, fs.n2, fs.t1_fwd, None),
            ("c", 1, fs.n1, fs.n2, fs.t1_inv, dom.h_out)):
        m = NTT.prefix_rows(S, L)
        x = rand_fq(torch, (B, S, L), gen)
        outs, ms, pms, err = compare(
            torch, f"ntt_stage_fr ({tag})",
            lambda a, t: (NTT.ntt_stages(a, t, 2 * m, table),),
            lambda a, t: (NTT.ntt_stages_plain(a, t, 2 * m, table),),
            (x, tw), reps=5)
        stages = (S // m).bit_length() - 1
        # a product a butterfly whose twiddle is not w^0 = 1, one a value
        # for the store
        muls = B * L * sum(S // 2 - S // (2 * (m << u))
                           for u in range(stages))
        row("ntt_stage_fr", ntt_src, "za_tpu/engine/ntt_rns.py:156",
            f"({tag}) {B} x {S} x {L}, m_fuse {m}, {stages} stages"
            + (", scale_out" if table is not None else ""), ms, pms, err,
            nbytes(x, outs[0], tw, *([table] if table is not None else [])),
            muls + (B * S * L if table is not None else 0))
        rows[-1].update(ptxas_usage(
            ntt_log, f"{KERNEL_FN['ntt_stage_fr']}{stages}E"))
        rows[-1]["tail"] = tag

    for is_g2 in (False, True):
        g = "g2" if is_g2 else "g1"
        # the table build's widest launch: one staging block of points;
        # in G2 also the 2^13 rung's dense b_g2 tables
        npts = 3 * (1 << 16) if not is_g2 else 1 << 15
        widths = [npts] + ([dctx["staged"]["b_g2x"].n] if is_g2 else [])
        E = (8, 2) if is_g2 else (8,)
        for n in widths:
            pts = [rand_fq(torch, E[1:] + (n,), gen) for _ in range(6)]
            outs, ms, pms, err = compare(
                torch, f"ec_add_{g}",
                lambda *a: ec.ec_add(a[:3], a[3:6], is_g2),
                lambda *a: ec.ec_add_plain(a[:3], a[3:6], is_g2), pts, reps=5)
            row(f"ec_add_{g}", ec_src, "za_tpu/engine/ec.py:453",
                f"{n} points", ms, pms, err, nbytes(*pts, *outs),
                ADD_MULS[is_g2] * n)
            rows[-1].update(ptxas_usage(ec_log, KERNEL_FN[f"ec_add_{g}"]))
        coords = [rand_fq(torch, E[1:] + (8 * npts,), gen) for _ in range(3)]
        outs, ms, pms, err = compare(
            torch, f"to_affine_{g}",
            lambda *a: ec.to_affine(*a, is_g2),
            lambda *a: ec.to_affine_plain(*a, is_g2), coords, reps=2)
        nz = int((coords[2] != 0).reshape(-1, 8 * npts).any(0).sum())
        blocks = affine_blocks(8 * npts, is_g2)
        row(f"to_affine_{g}", ec_src, "za_tpu/engine/msm_tree.py:422",
            f"{8 * npts} points", ms, pms, err, nbytes(*coords, *outs),
            AFFINE_MULS[is_g2] * nz + blocks * INV_GCD_MULS)
        rows[-1].update(ptxas_usage(ec_log, KERNEL_FN[f"to_affine_{g}"]))
        rows[-1]["blocks"] = blocks
    rows.extend(fixed_base_rows(torch, sctx, launches, warp_us))
    staging_edge_checks(torch, gen)
    # launches of one prove at each rung, staging excluded
    for r in rows:
        key = r["name"]
        if "mode" in r:
            key = f"ntt_prefix_fr.{r['mode']}"
        r["launches_per_proof"] = tctx["per_proof"].get(key, 0)
        for log2n, ctx in ((LOG2N_DENSE, dctx), (LOG2N_BIG, bctx)):
            r[f"launches_per_proof_2^{log2n}"] = ctx["per_proof"].get(
                key, 0)
    return rows


def fixed_base_rows(torch, sctx, launches, warp_us) -> list:
    """The setup's kernels at the 2^17 setup's widths, exact against
    their plain versions: the c = 8 table of G1 and of G2 as its two
    kernels, the ladder (D_0 .. D_254 of the generator) and the window
    levels (the table from that ladder, in its level_launches), the MSM
    on the h query's 2^18 - 1 G1 scalars and on b_g2's 2^17 + 2 G2
    scalars (the setup's own).  Bounds count the least work of the same
    result, bytes each input (base, ladder or table, scalars) read once
    and each output written once.  The ladder: its 254 doublings
    (DBL_MULS); "chain_floor_ms" is those doublings times the staged
    add's latency measured by the Horner rows, "floor_ratio" its ms over
    that floor, and beside it the whole table, ladder then levels
    ("table_ms", equal to the levels row's output) over the same floor
    ("table_floor_ratio").  The levels: one add an entry whose digit has
    two set bits or more (each is one add from an entry of one bit
    fewer; an entry of one bit is a ladder point), an entry of the top
    window that repeats a lower one (a bit past D_254) none.  The MSM:
    the nonzero digits less one a nonzero scalar."""
    from za_tpu_torch.curve import G1_GEN, G2_GEN
    from za_tpu_torch.engine import _build, ec, field as F
    from za_tpu_torch.engine import fixed_base as FB

    src = "za_tpu_torch/csrc/fixed_base.cu"
    fb_log = (_build.build_dir() / "fixed_base.log").read_text()
    c, W = 8, FB.windows(8)
    doublings = FB.LADDER - 1
    table_adds = sum(
        bin(d).count("1") >= 2 and d < 1 << min(c, FB.LADDER - c * w)
        for w in range(W) for d in range(1 << c))
    rows = []

    def add(name, replaces, shape, ms, pms, err, bmoved, adds, is_g2,
            dbls=0):
        b_ms, by = bound(bmoved, ADD_MULS[is_g2] * adds
                         + DBL_MULS[is_g2] * dbls)
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": float(ms), "device_ms": float(ms),
            "issue_ms": ms.issue, "plain_ms": pms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None, "shape": shape,
            "adds": adds,
            "launches_per_setup_2^17": sctx["launches"][name],
            **ptxas_usage(fb_log, KERNEL_FN[name])})
        log(f"{name} [{shape}]: {ms:.4f} ms (plain {pms:.1f} ms, bound "
            f"{b_ms:.4f} ms by {by}), launches {launches[name]}, "
            f"{rows[-1]['regs']} regs, {rows[-1]['spill_bytes']} B spill")
        return rows[-1]

    for is_g2, scs in ((False, sctx["h_s"]), (True, sctx["v"])):
        g = "g2" if is_g2 else "g1"
        base = ec.points_to_device([G2_GEN if is_g2 else G1_GEN], is_g2,
                                   "cuda")
        lad, ms, pms, err = compare(
            torch, f"fixed_base_ladder_{g}",
            lambda *b: FB.fixed_base_ladder(b, c, is_g2),
            lambda *b: FB.fixed_base_ladder_plain(b, c, is_g2), base, reps=3)
        ladder = add(f"fixed_base_ladder_{g}", "za_tpu/engine/msm.py:295",
                     f"D_0 .. D_{lad[0].shape[-1] - 1}", ms, pms, err,
                     nbytes(*base, *lad), 0, is_g2, doublings)
        tab, ms, pms, err = compare(
            torch, f"fixed_base_levels_{g}",
            lambda *d: FB.fixed_base_windows(d, c, is_g2),
            lambda *d: FB.fixed_base_windows_plain(d, c, is_g2), lad,
            reps=3)
        add(f"fixed_base_levels_{g}", "za_tpu/engine/msm.py:308",
            f"c = {c}, {W} x {1 << c} entries, "
            f"{len(FB.level_launches(c))} launches", ms, pms, err,
            nbytes(*lad, *tab), table_adds, is_g2)
        whole = FB.fixed_base_table(base, c, is_g2)
        assert all(torch.equal(x, y) for x, y in zip(whole, tab)), (
            f"fixed_base_table_{g}: differs from its ladder's levels")
        floor = doublings * warp_us[g] / 1e3
        table_ms = device_ms(torch, lambda: FB.fixed_base_table(base, c,
                                                                is_g2))
        ladder.update(doublings=doublings, chain_floor_ms=floor,
                      floor_ratio=ladder["ms"] / floor, table_ms=table_ms,
                      table_floor_ratio=table_ms / floor)
        log(f"fixed_base_table_{g}: {table_ms:.4f} ms, ladder "
            f"{ladder['ms']:.4f} + levels {ms:.4f}; chain floor "
            f"{floor:.4f} ms, ladder {ladder['floor_ratio']:.3f}x, table "
            f"{ladder['table_floor_ratio']:.3f}x")
        sc = torch.from_numpy(F.ints_to_limbs(scs).astype("int32")).cuda()
        outs, ms, pms, err = compare(
            torch, f"fixed_base_msm_{g}",
            lambda *a: FB.fixed_base_msm(a[:3], a[3], c, is_g2),
            lambda *a: FB.fixed_base_msm_plain(a[:3], a[3], c, is_g2),
            (*tab, sc), reps=3)
        nz = FB.digits(sc, c) != 0
        adds = int(nz.sum()) - int(nz.any(0).sum())
        add(f"fixed_base_msm_{g}", "za_tpu/engine/msm.py:379",
            f"{len(scs)} scalars ({'b_g2' if is_g2 else 'h'} at 2^{LOG2N}), "
            f"c = {c}", ms, pms, err, nbytes(*tab, sc, *outs), adds, is_g2)
    return rows


def carry_muls(C: int, g2: bool) -> int:
    """Fq products of one column of the carry's fold-half over C chunks:
    C - 1 complete adds, less the products an operand still a partial
    (Z 0 or 1) saves (csrc/curve.cuh point_add's z01; csrc/ec.cu
    fold_levels: at level h lane c + h is one if c + 3h >= C, lane c
    too if c + 2h >= C): z1 z2 where the second is (1 in G1, an Fq2
    product, 3, in G2), and the two cross terms too where both are."""
    fq2 = 3 if g2 else 1
    P = 1 << (C - 1).bit_length()
    muls, h = 0, P // 2
    while h >= 1:
        for c in range(h):
            if c + h < C:
                muls += ADD_MULS[g2] - fq2 * (3 if c + 2 * h >= C else
                                              1 if c + 3 * h >= C else 0)
        h //= 2
    return muls


def tail_rows(torch, tctx, dctx, gen, launches, warp_us, ec_log) -> list:
    """Rows of the lane fold at every shape a proof gives it (each MSM's
    (M, W, L)) and of the carry at each 2^17 MSM's (C, M, 64, 128), on
    random points (a tenth of the fold's lanes at (0 : 1 : 0), and two
    whole windows; a tenth of the carry's partials flagged at infinity),
    exact against the plain versions; ms the device time of one launch,
    median of 5 (device_ms).  Bounds count one complete add per pair
    (carry_muls: the (C - 1) M W T adds, the products left out that a
    partial's Z of 0 or 1 saves); "chain_floor_ms" is the
    dependent levels (log2 L of a fold, ceil(log2 C) of a carry) times
    the staged add's latency measured by the Horner rows."""
    from za_tpu_torch.engine import cuda_tree as CT, ec, msm as MSM
    from za_tpu_torch.engine import msm_dense as MD, msm_tree as MT

    timer = Timer(torch)
    src = "za_tpu_torch/csrc/ec.cu"
    replaces = {"ec_fold": "za_tpu/engine/msm.py:684",     # lane_fold
                "ec_carry": "za_tpu/engine/msm_tree.py:639"}  # carry scan
    shapes = []   # (where, staged tables, lanes)
    for tag in ("g1abl", "g1h", "b_g2x"):
        shapes.append((f"2^{LOG2N} {tag}", tctx["staged"][tag], CT.TAIL))
    for st, style in ((dctx["staged"], ""), (dctx["fstaged"], " fused")):
        for tag in ("g1x4", "b_g2x"):
            t = st[tag]
            shapes.append((f"2^{LOG2N_DENSE}{style} {tag}", t,
                           MD.plan(t)[0]))
    out = []

    def differ(name, outs, want) -> int:
        err = max(int((a != b).sum()) for a, b in zip(outs, want))
        assert err == 0, f"{name}: kernel differs from its plain version"
        return err

    def add_row(name, shape, ms, pms, err, bmoved, muls, floor_us,
                fn_ms, fn=None):
        b_ms, by = bound(bmoved, muls)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name[:-3]], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "device_ms": ms,
            "issue_ms": issue_ms(torch, fn_ms), "plain_ms": pms,
            "bound_ms": b_ms,
            "bound_by": by, "library_ms": None, "shape": shape,
            "chain_floor_ms": floor_us / 1e3,
            **ptxas_usage(ec_log, KERNEL_FN[fn or name])})
        log(f"{name} [{shape}]: {ms:.4f} ms (plain {pms:.1f} ms, bound "
            f"{b_ms:.4f} ms by {by}, chain floor {floor_us / 1e3:.4f} ms)")

    for where, tabs, L in shapes:
        g2, g = tabs.is_g2, "g2" if tabs.is_g2 else "g1"
        W = MSM.WINDOWS[4 if isinstance(tabs, MT.AffineTables)
                        else MD.BITS[tabs.radix]]
        E = (2,) if g2 else ()
        pts = [rand_fq(torch, E + (tabs.m, W, L), gen) for _ in range(3)]
        # identity lanes: a tenth of them, and every lane of window 1 of
        # the first MSM and of the last window of the last MSM
        ident = torch.rand((tabs.m, W, L), generator=gen,
                           device="cuda") < 0.1
        ident[0, 1] = True
        ident[-1, -1] = True
        m = ident.view((1,) * ec.elem_axes(g2) + tuple(ident.shape))
        pts = [torch.where(m, i, c)
               for c, i in zip(pts, ec.identity_like(pts[0], g2))]
        want, pms = timer(lambda: MSM.lane_fold_plain(pts, g2))
        outs = MSM.lane_fold(pts, g2)
        err = differ(f"ec_fold_{g}", outs, want)
        fold = lambda: MSM.lane_fold(pts, g2)   # noqa: E731
        ms = device_ms(torch, fold)
        B, K, warps, wide = MSM.fold_plan(tabs.m * W, L, g2, pts[0].device)
        threads = not g2 and max(L // K, K) * B // 2 > wide
        add_row(f"ec_fold_{g}", f"{where} M={tabs.m} W={W} L={L}, "
                f"{B} windows a block, {K} blocks a window, {warps} warps, "
                + (f"levels over {wide} adds one a thread" if threads else
                   "every level staged"), ms, pms * 1e3, err,
                nbytes(*pts, *outs), ADD_MULS[g2] * tabs.m * W * (L - 1),
                (L.bit_length() - 1) * warp_us[g], fold,
                f"ec_fold_{g}" + ("" if threads or g2 else ".staged"))
        if isinstance(tabs, MT.AffineTables):
            C, n = tabs.chunks, tabs.m * W * L
            x, y = (rand_fq(torch, (C,) + E + (tabs.m, W, L),
                            gen).movedim(0, 1).contiguous() for _ in "xy")
            inf = torch.rand((C, tabs.m, W, L), generator=gen,
                             device="cuda") < 0.1
            want, pms = timer(lambda: CT.chunk_carry_plain(x, y, inf, g2))
            outs = CT.chunk_carry(x, y, inf, g2)
            err = differ(f"ec_carry_{g}", outs, want)
            carry = lambda: CT.chunk_carry(x, y, inf, g2)  # noqa: E731
            ms = device_ms(torch, carry)
            B, warps = CT.carry_plan(C, n, g2, x.device)
            add_row(f"ec_carry_{g}", f"{where} C={C} M={tabs.m} W={W} T={L}"
                    f", {B} columns a block, {warps} warps", ms,
                    pms * 1e3, err, nbytes(x, y, inf, *outs),
                    n * carry_muls(C, g2),
                    (C - 1).bit_length() * warp_us[g], carry)
    return out


def ntt_routes(torch, cached):
    """One 3-leg forward transform (l32, no modes) through the four-step
    at each 2^k of ROUTE_LOG2, held equal to the plain versions' (the
    same steps on the card as tensor code) and, up to 2^ROUTE_HOST_LOG2,
    each leg to the host Domain.ntt; CUDA-event ms, median of 5 after a
    warm-up.  cached: {n: FourStepTables} the paths built."""
    from za_tpu_torch.engine import field as F, ntt as NTT
    from za_tpu_torch.groth16.domain import Domain

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for k in ROUTE_LOG2:
        n = 1 << k
        host = Domain(n)
        fs = cached.get(n) or NTT.FourStepTables(host, "cuda")
        x = rand_fq(torch, (3, n), gen)
        t2, t1, inter = fs.tables(False)

        def fourstep():
            return NTT.fourstep_core(x, t2, t1, inter, fs.n1, fs.n2)

        y = fourstep()
        a = NTT.sub_ntt_plain(x.reshape(8, 3, fs.n2, fs.n1), t2, fs.n2)
        a = NTT.sub_ntt_plain(NTT.ntt_twiddle_plain(a, inter), t1, fs.n1)
        assert torch.equal(y, a.reshape(8, 3, n)), f"2^{k}: plain"
        if k <= ROUTE_HOST_LOG2:
            got = F.FR.from_mont(F.unpack(y).reshape(F.NLIMBS, -1)).cpu()
            got = F.limbs_to_ints(got.numpy())
            vals = F.FR.from_mont(F.unpack(x).reshape(F.NLIMBS, -1)).cpu()
            vals = F.limbs_to_ints(vals.numpy())
            for b in range(3):
                assert got[b * n:(b + 1) * n] == host.ntt(
                    vals[b * n:(b + 1) * n]), f"2^{k}: host, leg {b}"
        ms = {"fourstep": statistics.median(
            timer(fourstep)[1] for _ in range(5)) * 1e3,
            "m_fuse": [NTT.prefix_rows(fs.n2, fs.n1),
                       NTT.prefix_rows(fs.n1, fs.n2)],
            "checked": "host" if k <= ROUTE_HOST_LOG2 else "plain"}
        out[f"2^{k}"] = ms
        log(f"NTT at 2^{k} (3 legs, {fs.n2} x {fs.n1}): {ms}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    # the engine's stage timer stays off in this process but where a
    # check turns it on (engine.metrics reads the variable at import)
    os.environ.pop("ZA_METRICS", None)
    try:
        from za_tpu_torch.engine import _build
    except ImportError as exc:
        print(f"chip_smoke: the za_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 2
    sys.setrecursionlimit(100_000)
    t_start = time.time()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    built = _build.build_all()
    build_s = time.time() - t0
    log(f"kernels built in {build_s:.1f}s: {built}")
    for f in sorted(_build.build_dir().glob("*.log")):
        for line in f.read_text().splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"{f.stem}: {line.strip()}")

    timer = Timer(torch)
    tree, tree_launches, tctx = prove_path(torch, timer, LOG2N)
    assert tree["route"] == "tree", "2^17 did not take the tree"
    dense, dense_launches, dctx = prove_path(torch, timer, LOG2N_DENSE)
    assert dense["route"] == "dense", "2^13 did not take the dense path"
    check_launches, setup510_launches = real_proof()
    dense["off_curve_refused"] = off_curve_refused(dctx["params"],
                                                   dctx["r1cs"])
    big, big_launches, bctx = prove_path(torch, timer, LOG2N_BIG, lean=True)
    assert big["route"] == "tree", f"2^{LOG2N_BIG} did not take the tree"
    bctx = {"per_proof": bctx["per_proof"],
            "dom": bctx["eng"]._domain(bctx["m"])}   # the tables go
    cli, cli_launches, circuit = cli_path(torch, root)
    stage_metrics = cli.pop("stage_metrics")
    setup, setup_launches, sctx = setup_path(torch, circuit)
    del circuit
    mesh, mesh_paths = mesh_phases(torch, root, tctx, dctx, card)
    per_path = {"tree": tree_launches["default"],
                "dense": dense_launches["default"],
                "fused": dense_launches["fused"],
                "check510": check_launches,
                f"tree_2^{LOG2N_BIG}": big_launches["default"],
                f"cli_2^{LOG2N}": cli_launches,
                "setup510": setup510_launches,
                f"setup_2^{LOG2N}": setup_launches, **mesh_paths}
    launches = {k: sum(p[k] for p in per_path.values())
                for k in _build.KERNELS}
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels launched on no path: {missing}"
    # h(x)'s kernels on every path; the store mode in the prefix where it
    # ends the coset iNTT, in the tail at 2^20
    h_kernels = ("ntt_prefix_fr", "ntt_twiddle_fr", "r1cs_matvec_fr",
                 "ntt_prefix_fr.scale_in", "ntt_prefix_fr.combine")
    for path, ctx, store in (("tree", tctx, "ntt_prefix_fr.scale_out"),
                             ("dense", dctx, "ntt_prefix_fr.scale_out"),
                             (f"tree_2^{LOG2N_BIG}", bctx, "ntt_stage_fr")):
        idle = [k for k in h_kernels + (store,)
                if ctx["per_proof"].get(k, 0) == 0]
        assert not idle, f"{path}: h(x) did not run on kernels: {idle}"
    # the tail: one launch a sub-NTT tail of the 2^20 proof's three
    # transforms, on no other path
    tails = {p: v["ntt_stage_fr"] for p, v in per_path.items()}
    assert bctx["per_proof"]["ntt_stage_fr"] == 6 and tails == {
        **{p: 0 for p in per_path}, f"tree_2^{LOG2N_BIG}": 6}, \
        f"ntt_stage_fr launches: {tails}, a 2^20 proof " \
        f"{bctx['per_proof']['ntt_stage_fr']}"
    # the setup's kernels on the setup paths alone
    fb = [k for k in launches if k.startswith("fixed_base_")]
    stray = {p: {k: v[k] for k in fb if v[k]} for p, v in per_path.items()
             if not p.startswith("setup") and any(v[k] for k in fb)}
    assert not stray, f"fixed-base kernels off the setup paths: {stray}"
    rows = kernels_vs_plain(torch, tctx, dctx, bctx, launches, sctx)
    tree["ntt_routes_ms"] = ntt_routes(torch, {
        d: ctx["eng"]._domain(d).fourstep
        for d, ctx in ((1 << (LOG2N + 1), tctx),
                       (1 << (LOG2N_DENSE + 1), dctx))}
        | {bctx["dom"].size: bctx["dom"].fourstep})

    for result in (tree, dense, big, cli, stage_metrics, setup):
        result.update({"device": torch.cuda.get_device_name(0),
                       "card": card})
    tree.update({"build_s": build_s, "smoke_s": time.time() - t_start,
                 "check510_launches": check_launches})
    big[f"launches_per_proof_2^{LOG2N_BIG}"] = big.pop(
        "launches_per_proof")
    print(json.dumps(tree))
    print(json.dumps(dense))
    print(json.dumps(big))
    print(json.dumps(cli))
    print(json.dumps(stage_metrics))
    print(json.dumps(setup))
    print(json.dumps(mesh))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
