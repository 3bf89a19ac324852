"""The card's clock and the work counts that bound a kernel.

card_line names the card; time_kernel and profiled_ms time a call on it
(CUDA events after a spin, and torch.profiler's device time);
level_ops ... qgram_bound count the least work of each kernel's function
at its inputs and turn it into (bound_ms, bound_by) at the peak rates of
one H100 below.  chip_smoke.py, agrep_tpu_torch.bench and the timing
tools under tools/ use them.
"""

from __future__ import annotations

import subprocess

# H100 SXM peaks (NVIDIA data sheet): HBM3 at 3.35 TB/s; 67 TFLOP/s fp32
# outside the tensor cores is 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz, and
# an SM has half as many int32 lanes: 132 x 64 x 1.98e9 int32 op/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# shared memory serves 128 B a clock per SM: 32 four-byte loads, issued
# on the load/store pipe beside the int32 lanes
SHARED_LOADS_PER_S = 132 * 32 * 1.98e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def level_ops(m) -> int:
    """int32 operations of one pass over the D+1 levels at their least:
    the expressions of kernels._levels with the ANDs and ORs fused into
    three-input logic ops (LOP3; one input may be a constant such as
    init1, noerr or the sgrep high bit), as regex_byte_ops counts them.
    Each shift is one op."""
    D = m.D
    if m.variant == "sgrep":
        # level 0: >>, LOP3 (a | H) & cm; level k: s[k] >> 1, the |
        # of new[k-1] and s[k-1] and its >> 1, LOP3 (a | H) & cm, LOP3
        # x | s[k-1] | v, and the | H
        return 2 + 6 * D
    if m.costs is None:
        # level 0: >>, s & init1, LOP3 (a & cm) | t; level k: s[k] >> 1,
        # new[k-1] | s[k-1] and its >> 1, then three LOP3: (s[k] & init1)
        # | s[k-1], (a & cm) | t and (v & noerr) | x
        return 3 + 6 * D
    ci, cs, cd = m.costs
    n = 0
    for k in range(D + 1):
        # >>, (s & init1) | s[k-ci] in one LOP3, LOP3 (a & cm) | t; the
        # error edges: their | when there are two, the >> and one LOP3
        # (e & noerr) | r
        err = (k - cs >= 0) + (k - cd >= 0)
        n += 3 + (err + 1 if err else 0)
    return n


def ops_per_column(m) -> int:
    """int32 operations of one text column at their least: the byte's
    extract from a wide load and its scale to a table address (2), the
    level pass, and for each hit mask a LOP3 that tests it into a
    predicate and a predicated OR that sets the column's bit; for bitap
    with a delimiter also the trigger's test and bit (2) and the D+1
    state selects.  The table load is a shared load (bound counts it
    apart); a plane word's store, one each 32 columns, is not
    counted."""
    n = 2 + level_ops(m) + 2 * len(m.hit_masks)
    if m.variant == "sgrep":
        return n + (1 if m.D else 0)       # the newline test
    if m.d_endpos:
        return n + 2 + (m.D + 1)
    return n


def restart_ops(m) -> int:
    """Extra operations of one delimiter restart: a second level pass
    and the d_mask gate."""
    return level_ops(m) + 1


def text_bits(plane, N: int, W: int, L: int) -> int:
    """Set bits of one [T, n_words] plane at the text's N columns:
    columns W..W+L-1 of each tile (bit j of word w is column 32w + j),
    the last tile's only up to the text's end."""
    import torch
    T, n_words = plane.shape
    p = plane.to(torch.int64)
    col = torch.arange(32 * n_words, device=p.device).view(n_words, 32)
    last = N - (T - 1) * L
    n = 0
    for b in range(32):
        bits = (p >> b) & 1
        c = col[:, b]
        n += int((bits[:-1] * ((c >= W) & (c < W + L))).sum().item())
        n += int((bits[-1] * ((c >= W) & (c < W + last))).sum().item())
    return n


def bound(m, N: int, W: int, L: int, planes) -> tuple:
    """(bound_ms, bound_by) of one scan of N bytes: each input byte read
    once and each plane's N bits written once over HBM's rate, against
    the int32 operations of the N text columns (plus the restarts their
    delimiters trigger) over the card's int32 rate, and a column's
    table load over the shared-memory rate.  A tile's W warm-up columns
    are the windowed design's work, not the function's: a sequential
    pass does N columns, and they are not counted."""
    n_bytes = N + 256 * 4 + planes.shape[0] * 4 * -(-N // 32)
    triggers = 0
    if m.variant == "bitap" and m.d_endpos:
        triggers = text_bits(planes[0], N, W, L)
    ops = N * ops_per_column(m) + triggers * restart_ops(m)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(ops / INT32_OPS_PER_S, N / SHARED_LOADS_PER_S)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def nxt_ops(M: int) -> tuple:
    """(int32 operations, shared loads) of one nxt at its least: a load
    from the reference's tabulated Next (ops/renfa.py
    next_tables_arrays), indexed by the state's bits 1..M-1.  Up to 15
    index bits the table (128 KB at most) fits the 227 KB of shared
    memory a block can take: one three-input logic op (LOP3) masks the
    index, with an OR of two states fused in, one LEA scales it to an
    address, one load.  Above 15, two half tables: two index and two
    scale ops, one OR, two loads.  M <= 1: nxt is the constant head
    bit."""
    rel = max(M - 1, 0)
    if rel == 0:
        return 0, 0
    return (2, 1) if rel <= 15 else (5, 2)


def regex_byte_ops(D: int, M: int) -> tuple:
    """(int32 operations, shared loads) of one text byte of the lanes
    machine at its least, with the ORs and ANDs fused into LOP3s.  nxt is
    an OR over the set bits of its argument, so re1's nxt(s[k-1] |
    nw[k-1]) is nxt(s[k-1]) | nxt(nw[k-1]), both already at hand when
    each state's nxt is carried beside it: a byte takes one nxt a level.
    The byte's extract from a wide load and its scale to a CMask address
    (2) and the CMask load; level 0 is (n & cm) | (init1 & s) (2 LOP3)
    and the new state's nxt; level k is the eight-input combine (4 LOP3)
    and the new state's nxt.  The loop's control, amortized by
    unrolling, is not counted."""
    no, nl = nxt_ops(M)
    return 2 + 2 + no + D * (4 + no), 1 + nl * (D + 1)


def regex_verdict_ops(tail: bool, M: int) -> tuple:
    """(int32 operations, shared loads) of a line's verdict at its
    newline at its least: CMask['\\n'] is a constant and nxt(s[D]) is
    carried; 2 LOP3 form ad; the tail step is nxt and a LOP3 that takes
    the & 1 too (without it, the & 1 alone)."""
    no, nl = nxt_ops(M)
    if tail:
        return no + 3, nl
    return 3, 0


def regex_bound(m, n_text: int, lens) -> tuple:
    """(bound_ms, bound_by) of one lanes launch over R lines, from the
    function's least work (not this kernel's): the largest of the text
    read once, 16 B of line index and 1 B of verdict a line and the
    machine (CMask and the follow bits) over HBM's rate; the int32
    operations of every line's bytes and verdict over the card's int32
    rate; and their shared loads over the shared-memory rate."""
    R = len(lens)
    n_bytes = n_text + 17 * R + 256 * 4 + 4 * m.M
    (bo, bl), (vo, vl) = (regex_byte_ops(m.D, m.M),
                          regex_verdict_ops(m.tail, m.M))
    n = int(lens.sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max((n * bo + R * vo) / INT32_OPS_PER_S,
                (n * bl + R * vl) / SHARED_LOADS_PER_S)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def chain_ops() -> tuple:
    """(int32 operations, shared loads) of one text byte of the chain
    function at its least: a multi-string (Aho-Corasick) automaton over
    the folded classes with its transition table in shared memory
    (config 5's 784 states times 32 classes at 2 B an entry is 50 KB):
    the byte's class load and the transition load, the next-state index
    (one IMAD), the state's accept bit tested and merged into the output
    word (2 LOP3/SHF).  Moving a match's bit from its end to its start
    costs a few operations for each of the run's sparse matches, which
    this count leaves out."""
    return 3, 2


def chain_bound(N: int) -> tuple:
    """(bound_ms, bound_by) of one chain scan of N bytes: the text read
    once and the start plane written once over HBM's rate, against
    chain_ops over the int32 and shared-load rates.  The TPU kernel's
    bit-plane form does about 80 operations a byte for config 5's terms:
    that is one design's count, not the function's least work, and is
    not the bound."""
    ops, loads = chain_ops()
    t_bytes = (N + 4 * -(-N // 32)) / HBM_BYTES_PER_S
    t_ops = max(N * ops / INT32_OPS_PER_S, N * loads / SHARED_LOADS_PER_S)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def qgram_ops() -> tuple:
    """(int32 operations, shared loads) of one text byte of the q-gram
    filter at its least: the byte's low 5 bits (kept for the next byte's
    previous), the member word's load (its index is those bits), the
    shift by the previous byte's bits and the bit's merge into the
    output word (2 LOP3/SHF), and the byte's extract from a wide load."""
    return 4, 1


def qgram_bound(N: int) -> tuple:
    """(bound_ms, bound_by) of one q-gram filter of N bytes: the text
    read once, the 128 B member set and the candidate plane written once
    over HBM's rate, against qgram_ops over the int32 and shared-load
    rates."""
    ops, loads = qgram_ops()
    t_bytes = (N + 128 + 4 * -(-N // 32)) / HBM_BYTES_PER_S
    t_ops = max(N * ops / INT32_OPS_PER_S, N * loads / SHARED_LOADS_PER_S)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# clock cycles the card spins a timed call before time_kernel's first
# event (about 0.1 ms at 1.98 GHz)
SPIN_CYCLES = 200000


def time_kernel(fn, reps: int = 5) -> float:
    """ms per call of fn on the card: CUDA events around reps calls after
    one warm-up call.  The card first spins (SPIN_CYCLES a call, doubled
    up to 4 times while too short), so that the host has queued every
    call before the first event: the events then hold the calls' device
    time, not the host's time to launch them.  That the spin outlasted
    the queuing is checked -- the first event must still be pending once
    the last call is queued -- and a timing whose spin never did raises,
    as does an fn that waits for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    for k in range(5):
        torch.cuda._sleep(SPIN_CYCLES * reps << k)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_first = not a.query()
        torch.cuda.synchronize()
        if queued_first:
            return a.elapsed_time(b) / reps
    raise RuntimeError("time_kernel: the card finished its spin of %d "
                       "cycles before the host had queued %d calls"
                       % (SPIN_CYCLES * reps << 4, reps))


def profiled_ms(fn, kernel: str, reps: int):
    """Device ms per launch of the kernels whose name holds `kernel`, as
    torch.profiler's CUDA activity reads them over reps calls of fn, or
    None when the trace holds no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", 0) for e in evs)
    count = sum(e.count for e in evs)
    return total / count / 1e3 if count and total else None
