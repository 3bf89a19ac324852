"""The least time of a search's function on one H100, from the cell's
inputs alone.

The counts are a frozen copy of agrep_tpu_torch/ops/timing.py at commit
fe63a388977a (HBM_BYTES_PER_S, INT32_OPS_PER_S, SHARED_LOADS_PER_S,
level_ops, ops_per_column, nxt_ops, regex_byte_ops and
regex_verdict_ops), so that a change to the program cannot move the
yardstick.  They take a machine described by the configuration's
"roofline" entry, never the program's objects, so the same work is
counted whatever kernels carry the search out, fused or split.

A search's least time is the larger of
- its bytes over HBM's rate: the input read once and each output row
  (three int64) written once, and
- its int32 operations over the int32 rate (and its table loads over the
  shared-memory rate): the automaton's operations a byte times the bytes.
"""

from __future__ import annotations

from types import SimpleNamespace

# H100 SXM peaks (NVIDIA data sheet): HBM3 at 3.35 TB/s; 67 TFLOP/s fp32
# outside the tensor cores is 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz, and
# an SM has half as many int32 lanes: 132 x 64 x 1.98e9 int32 op/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# shared memory serves 128 B a clock per SM: 32 four-byte loads
SHARED_LOADS_PER_S = 132 * 32 * 1.98e9
ROW_BYTES = 24


def level_ops(m) -> int:
    """int32 operations of one pass over the D+1 levels at their least,
    the ANDs and ORs fused into three-input logic ops (LOP3)."""
    D = m.D
    if m.variant == "sgrep":
        return 2 + 6 * D
    if m.costs is None:
        return 3 + 6 * D
    ci, cs, cd = m.costs
    n = 0
    for k in range(D + 1):
        err = (k - cs >= 0) + (k - cd >= 0)
        n += 3 + (err + 1 if err else 0)
    return n


def ops_per_column(m) -> int:
    """int32 operations of one text column at their least: the byte's
    extract and table address (2), the level pass, a test and an OR for
    each hit mask, and with a delimiter the trigger's test and bit (2)
    and the D+1 state selects."""
    n = 2 + level_ops(m) + 2 * m.hit_masks
    if m.variant == "sgrep":
        return n + (1 if m.D else 0)
    if m.d_endpos:
        return n + 2 + (m.D + 1)
    return n


def nxt_ops(M: int) -> tuple:
    """(int32 operations, shared loads) of one step of a regex machine's
    Next table over M states (state 0 the start)."""
    rel = max(M - 1, 0)
    if rel == 0:
        return 0, 0
    return (2, 1) if rel <= 15 else (5, 2)


def regex_byte_ops(D: int, M: int) -> tuple:
    """(int32 operations, shared loads) of one text byte of the regex
    machine with D errors."""
    no, nl = nxt_ops(M)
    return 2 + 2 + no + D * (4 + no), 1 + nl * (D + 1)


def regex_verdict_ops(tail: bool, M: int) -> tuple:
    """(int32 operations, shared loads) of a line's verdict."""
    no, nl = nxt_ops(M)
    if tail:
        return no + 3, nl
    return 3, 0


def _least(n_bytes: int, ops: int, loads: int) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S,
               loads / SHARED_LOADS_PER_S)


def least_seconds(machine: dict, n_bytes: int, n_lines: int,
                  line_bytes: int, rows: int) -> float:
    """The least seconds of one search of n_bytes of input holding
    n_lines lines of line_bytes bytes in all (newlines left out), whose
    answer is rows rows; machine is the configuration's "roofline"
    entry."""
    kind = machine["kind"]
    out = n_bytes + ROW_BYTES * rows
    if kind == "bitap":
        m = SimpleNamespace(variant="bitap", D=machine["D"],
                            costs=machine.get("costs"),
                            hit_masks=machine["hit_masks"],
                            d_endpos=machine["delimiter"])
        return _least(out + 256 * 4, n_bytes * ops_per_column(m), n_bytes)
    if kind == "regex":
        D, M = machine["D"], machine["M"]
        bo, bl = regex_byte_ops(D, M)
        vo, vl = regex_verdict_ops(False, M)
        return _least(out + 256 * 4 + 4 * M,
                      line_bytes * bo + n_lines * vo,
                      line_bytes * bl + n_lines * vl)
    raise ValueError("unknown roofline kind %r" % kind)
