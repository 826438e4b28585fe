"""The frozen formulas give the bounds that PERF.md's kernel table states
for its shapes (chip_smoke.py's inputs: p3 at B=16 and B=4, 80% of the
proposal columns valid; B2 with 190 of 256 slots valid; B1' at p5)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from benchmark.harness import formulas  # noqa: E402

P3 = dict(M=16, N=128, P=16 * 28, D=256, Pc=64 * 64)


@pytest.mark.parametrize("B, want_ms", [(16, 0.0147), (4, 0.0037)])
def test_b1_bound_matches_the_kernel_table(B, want_ms):
    by = formulas.b1_bytes(B, P3["M"], P3["N"], P3["P"], P3["D"], P3["Pc"])
    ops = formulas.pool_cost_match_ops(B, P3["M"], P3["N"], P3["P"], P3["D"], P3["Pc"],
                                       30, int(B * 16 * 128 * 0.8))
    s, kind = formulas.bound_s(by, ops)
    assert kind == "bytes" and round(s * 1e3, 4) == want_ms


def test_b2_bound_matches_the_kernel_table():
    by = formulas.b2_bytes(16, 16, 190, 64, 112, 256, 448)
    ops = formulas.resolve_upsample_ops(190, 64, 256, 448)
    s, kind = formulas.bound_s(by, ops)
    assert kind == "bytes" and round(s * 1e3, 4) == 0.0022


def test_b1_backward_bound_matches_the_kernel_table():
    by = formulas.b1_backward_bytes(4, 8, 64, 16 * 28, 256, 64 * 64)
    assert round(by / 1e6, 2) == 14.10
    ops = 2 * formulas.pool_cost_match_ops(4, 8, 64, 16 * 28, 256, 64 * 64, 30, 4 * 8 * 51)
    s, kind = formulas.bound_s(by, ops)
    assert kind == "bytes" and round(s * 1e3, 4) == 0.0042


def test_b1_operations_count_what_the_kernel_computes():
    # pooling 2BNPD + BNP, intersections 2BMNPc + B(M+N)Pc, cosine 2BMND
    # + 2B(M+N)D, Sinkhorn 10 (iters + 1) per valid pair
    assert formulas.pool_cost_match_ops(1, 1, 1, 1, 1, 1, 0, 0) == 3 + 4 + 6
    assert formulas.pool_cost_match_ops(1, 1, 1, 1, 1, 1, 29, 1) == 13 + 300
