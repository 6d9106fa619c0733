"""The instruction count behind the port's issue-slot times (``ops/sass.py``).

``data/sass_excerpts.txt.gz`` holds ``cuobjdump -sass`` of five kernel
instances as nvcc 12.8 built them for sm_90a (``-fmad=false``), addresses and
instructions only: K1's ``heston_qe_kernel<0,0>``, K2's ``hybrid_kernel<0>``
and ``<1>`` for the north-star blocks (vasicek, bs, cirpp Euler), and the
substep ladder's ``qe-full`` and ``qe-batched-prng`` rungs.  The counts below
are the ones ``chip_smoke.py`` printed for those builds on the card.
"""

import gzip
from pathlib import Path
from types import SimpleNamespace

import pytest

from montecarlo_risk_engine_tpu_torch.ops import sass
from montecarlo_risk_engine_tpu_torch.ops.sass import IssueSlots, sass_functions, substep_loop

EXCERPTS = Path(__file__).resolve().parent / "data" / "sass_excerpts.txt.gz"


@pytest.fixture(scope="module")
def text():
    with gzip.open(EXCERPTS, "rt") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def funcs(text):
    return sass_functions(text)


def function(funcs, kernel):
    (name,) = [n for n in funcs if kernel in n]
    return funcs[name]


# (kernel, instructions per loop iteration, the same by the count that took
# no nested loop for a slow path).  K1 and the ladder's qe-full keep sincosf's
# large-argument reduction in registers, K2's hybrid_kernel<0> too: 110, 110
# and 222 instructions that no launch enters.  hybrid_kernel<1> and the
# batched rung keep it in local memory, which both counts leave out.
COUNTS = [
    ("heston_qe_kernelILb0ELb0E", 304, 414),
    ("hybrid_kernelILb0E", 284, 506),
    ("hybrid_kernelILb1E", 284, 284),
    ("heston_ladder_kernelILi4E", 303, 413),
    ("heston_ladder_kernelILi6E", 1141, 1141),
]


@pytest.mark.parametrize("kernel, count, without_nested", COUNTS,
                         ids=[c[0] for c in COUNTS])
def test_substep_loop_counts(funcs, kernel, count, without_nested):
    ins = function(funcs, kernel)
    body, slow = substep_loop(ins)
    assert len(body) - len(slow) == count
    body_old, slow_old = substep_loop(ins, nested_loops=False)
    assert body_old == body and slow_old <= slow
    assert len(body) - len(slow_old) == without_nested
    # the loop draws; what is left out of it draws nothing
    assert sass._draws(o for _, o, _ in body)
    assert not sass._draws(o for x, o, _ in body if x in slow)


def test_per_substep_and_issue_slot_time(text, monkeypatch):
    """The batched rung's loop runs a group of 4 substeps; K1's count by
    both rules; the issue-slot time chip_smoke.py printed for K1 (2^20
    paths x 40 substeps at 1980 MHz: 0.3811 ms)."""
    monkeypatch.setattr(sass, "sass_of", lambda built: text)
    issue, built = IssueSlots(1980.0), SimpleNamespace(path=EXCERPTS)
    assert issue.per_substep(built, "heston_ladder_kernelILi6E", 4) == 1141 / 4 == 285.25
    assert issue.per_substep(built, "heston_qe_kernelILb0ELb0E") == 304
    assert issue.per_substep(built, "heston_qe_kernelILb0ELb0E", nested_loops=False) == 414
    assert issue.per_substep(built, "no_such_kernel") is None
    assert issue.ms(304, (1 << 20) * 40) == pytest.approx(0.3811, abs=5e-5)
    assert issue.slot_ms("K1", built, "heston_qe_kernelILb0ELb0E", (1 << 20) * 40) == \
        issue.ms(304, (1 << 20) * 40)


def test_a_skipped_region_that_draws_is_refused():
    """A branch around whole substeps (a Philox call and a loop) is no slow
    path: counting it out would drop real work, so the count refuses."""
    mul = "IMAD.WIDE.U32 R4, R2, -0x2daee0ad, RZ"
    ins = [(0x00, "MOV R0, RZ", None)]
    ins += [(0x10 + 0x10 * i, mul, None) for i in range(10)]        # the substep's call
    ins += [(0xb0, "@P0 BRA 0x190", 0x190)]                         # skips 0xc0 .. 0x180
    ins += [(0xc0 + 0x10 * i, mul, None) for i in range(10)]        # another call
    ins += [(0x160, "IADD3 R0, R0, 0x1, RZ", None),
            (0x170, "@P1 BRA 0x160", 0x160),                        # a nested loop
            (0x180, "NOP", None),
            (0x190, "IADD3 R1, R1, 0x1, RZ", None),
            (0x1a0, "@P2 BRA 0x0", 0x0)]                            # the substep loop
    with pytest.raises(ValueError, match="skips a Philox call"):
        substep_loop(ins)
    body, slow = substep_loop(ins, nested_loops=False)  # no local memory: nothing skipped
    assert len(body) == len(ins) and not slow
