"""The mask-machine kernel's sub-tile split, proved on the CPU.

csrc/mask_scan.cu splits each tile's output words over s threads
(kernels.subtile_plan): sub-tile 0 scans from column 0, sub-tile i > 0
starts cold W columns before its first word and emits nothing while it
warms up.  split_model() below runs that decomposition with the plain
recurrence (every sub-tile of every tile at once, in numpy) and stitches
the sub-tiles' words into planes; the planes must equal
mask_scan_reference's bit for bit on every machine chip_smoke.py holds
the kernel to, at the edge sizes and for every split.  A machine with
sticky bits (init1_ns != init0) has no bounded warm-up, and the plan
gives it one sub-tile.  The kernel itself is held against
mask_scan_reference by chip_smoke.py on the GPU, for every split.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L

SPLITS = (1, 2, 4, 8)
MACHINES = {spec[0]: spec for spec in chip_smoke.parity_machines()}


def _machine(name):
    _n, table, consts, D, variant, costs = MACHINES[name]
    m = t_kernels.machine_from_arrays(table, consts, D, variant, costs,
                                      "cpu")
    return m, chip_smoke.halo(consts, D, L)


def _windows(text: np.ndarray, W: int, T: int) -> np.ndarray:
    """u8 [T, W+L]: column j of tile t is text[t*L - W + j], 0 outside."""
    padded = np.zeros(W + T * L, dtype=np.uint8)
    padded[W:W + len(text)] = text
    idx = np.arange(T)[:, None] * L + np.arange(W + L)[None, :]
    return padded[idx]


def split_model(texts: list, m, W: int, splits) -> dict:
    """{s: [planes u32 [1 + n_hit, T, n_words] of each text]} as the
    split kernel builds them: each sub-tile of subtile_plan runs the
    plain recurrence from a cold state at its start column (tile 0 of
    each text reset at column W), and only the columns of its own words
    are kept.  Every sub-tile of every split, tile and text steps at
    once, as the kernel's threads do."""
    S = W + L
    geo = [t_kernels.geometry(len(t), W, L) for t in texts]
    n_words = geo[0][1]
    win = np.concatenate([_windows(t, W, T) for t, (T, _) in zip(texts, geo)])
    tile0 = np.cumsum([0] + [T for T, _ in geo[:-1]])
    subs = [(s, start, 32 * lo, min(32 * hi, S)) for s in splits
            for start, lo, hi in t_kernels.subtile_plan(W, L, n_words, s)]
    starts = np.array([sub[1] for sub in subs])
    J = max(end - start for _s, start, _f, end in subs)
    cols = starts[:, None] + np.arange(J)[None, :]            # [P, J]
    win = win[:, np.minimum(cols, S - 1)]                      # [T, P, J]
    cms = m.table.numpy().astype(np.int64)[win]
    ini = t_kernels._init_levels(m)
    states = [np.full(cms.shape[:2], v, dtype=np.int64) for v in ini]
    rs = None
    if m.variant == "bitap" and m.d_endpos:
        rs = t_kernels._levels(m, [np.full_like(cms, v) for v in ini], cms)
        rs[0] = rs[0] & m.d_mask
    hms = np.array(m.hit_masks, dtype=np.int64)[:, None, None]
    bits = np.zeros((1 + len(m.hit_masks),) + cms.shape, dtype=bool)
    for j in range(J):
        at_reset = np.flatnonzero(cols[:, j] == W)
        for k in range(m.D + 1):
            states[k][np.ix_(tile0, at_reset)] = ini[k]
        if m.variant == "sgrep" and m.D > 0:
            nl = win[:, :, j] == 0x0A
            states = [np.where(nl, ini[k], states[k])
                      for k in range(m.D + 1)]
        new = t_kernels._levels(m, states, cms[:, :, j])
        bits[1:, :, :, j] = (new[m.D][None] & hms) != 0
        if rs is not None:
            trig = (new[0] & m.d_endpos) != 0
            bits[0, :, :, j] = trig
            new = [np.where(trig, rs[k][:, :, j], new[k])
                   for k in range(m.D + 1)]
        states = new
    # stitch: sub-tile p gives columns [first, end) of its split's planes
    out = {s: np.zeros((1 + len(m.hit_masks), len(win), 32 * n_words),
                       dtype=bool) for s in splits}
    for p, (s, start, first, end) in enumerate(subs):
        out[s][:, :, first:end] = bits[:, :, p, first - start:end - start]
    res = {}
    for s in splits:
        packed = np.packbits(out[s], axis=-1, bitorder="little")
        planes = packed.view("<u4")
        res[s] = [planes[:, a:a + T] for a, (T, _) in zip(tile0, geo)]
    return res


def _text(n: int, seed: int, dense: bool) -> np.ndarray:
    """chip_smoke's parity text (newlines every 61 bytes, planted words
    and '\\n\\n' delimiters), or with dense a newline or a '\\n\\n' in
    every few bytes."""
    rng = np.random.default_rng(seed)
    t = chip_smoke.random_text(n, rng)
    if dense:
        t[rng.integers(0, n, max(1, n // 5))] = 0x0A
    return t


SIZES = (1, "W-1", L, L + 1, 3 * L + 17, 64 << 10)
_RESULTS: dict = {}


def _results(name):
    """(texts, mask_scan_reference's planes, split_model's planes) of a
    machine, once for all its splits: chip_smoke's parity text at each
    size, with dense newlines at 3L+17."""
    if name not in _RESULTS:
        m, W = _machine(name)
        ns = [W - 1 if n == "W-1" else n for n in SIZES]
        texts = [_text(n, n, n == 3 * L + 17) for n in ns]
        want = [t_kernels.mask_scan_reference(torch.from_numpy(t), m, W,
                                              L).numpy() for t in texts]
        _RESULTS[name] = texts, want, split_model(texts, m, W, SPLITS)
    return _RESULTS[name]


@pytest.mark.parametrize("s", SPLITS)
@pytest.mark.parametrize("name", sorted(MACHINES))
def test_split_equals_whole_tile_scan(name, s):
    texts, want, got = _results(name)
    for text, w, g in zip(texts, want, got[s]):
        assert g.shape == w.shape
        bad = np.argwhere(g != w)
        assert bad.size == 0, (
            "%s s=%d N=%d: first (plane, tile, word) that differs: %s"
            % (name, s, len(text), bad[:4].tolist()))


@pytest.mark.parametrize("W", (0, 1, 31, 32, 33, 48, 64, 100, 1023, L))
def test_plan_covers_every_word_once(W):
    n_words = -(-(W + L) // 32)
    for s in SPLITS:
        plan = t_kernels.subtile_plan(W, L, n_words, s)
        assert len(plan) == s
        assert plan[0][:2] == (0, 0) and plan[-1][2] == n_words
        for (_a, _lo, hi), (_b, lo2, _hi2) in zip(plan, plan[1:]):
            assert hi == lo2
        for start, lo, hi in plan[1:]:
            assert start == 32 * lo - W >= 0 and hi > lo
        if s > 1:
            assert 32 * plan[0][2] >= W


def test_plan_refuses_a_split_with_an_empty_subtile():
    # 64 columns are two words: two sub-tiles at most, and with a
    # 32-column halo sub-tile 0 needs one of them
    with pytest.raises(ValueError):
        t_kernels.subtile_plan(32, 32, 2, 4)
    with pytest.raises(ValueError):
        t_kernels.subtile_plan(48, L, 35, 2)       # n_words is 34


@pytest.mark.parametrize("L_", (L, 64))
def test_choose_split_fills_the_card_with_the_least_split(L_):
    m, _ = _machine("bitap_D1")
    W, n_sm, tpb = 48, 132, t_kernels.TILES_PER_BLOCK
    n_words = -(-(W + L_) // 32)
    valid = []
    for s in SPLITS:
        try:
            t_kernels.subtile_plan(W, L_, n_words, s)
            valid.append(s)
        except ValueError:
            pass
    for T in (1, 100, 32768, 102400, 1 << 22):
        s = t_kernels.choose_split(m, T, W, L_, n_sm)
        busy = {v: t_kernels.busy_threads(T, W, L_, v, tpb, 1, n_sm)
                for v in valid}
        assert s in valid
        fill = t_kernels.FILL_THREADS_PER_SM
        if busy[s] >= fill:
            assert all(busy[v] < fill for v in valid if v < s)
        else:
            assert busy[s] == max(busy.values())
    # a 1 KB tile's staged bytes hold an SM to fewer threads than it
    # takes below eight sub-tiles; 64-byte tiles fill it with two
    big = t_kernels.choose_split(m, 1 << 22, W, L_, n_sm)
    assert big == (8 if L_ == L else 2)
    assert t_kernels.choose_split(m, 1, W, L_, n_sm) == valid[-1]


def test_shared_bytes_counts_the_staged_tiles():
    # 32 tiles of 1 KB with a 48-byte halo, plus alignment, slack and one
    # skew word every 1 KB
    assert t_kernels.shared_bytes(48, L, 8, 32, 1) == 4 * (8212 + 32 + 1)
    assert (t_kernels.shared_bytes(48, L, 8, 32, 2)
            - t_kernels.shared_bytes(48, L, 8, 32, 1)) == 4 * 8 * 32


def _sticky(name):
    """A bitap machine with a sticky bit: init1_ns keeps bit 0 of init0
    set forever, so no warm-up of bounded length gives the exact
    state."""
    m, W = _machine(name)
    return dataclasses.replace(m, init1_ns=m.init1_ns | 1), W


@pytest.mark.parametrize("name", ("bitap_D0", "bitap_D2",
                                  "bitap_costs211_D3", "bitap_parts12"))
def test_unbounded_machine_takes_one_subtile(name):
    m, W = _sticky(name)
    assert m.init1_ns != m.init0 and not t_kernels.bounded(m)
    for T in (1, 64, 1 << 20):
        assert t_kernels.choose_split(m, T, W, L, 132) == 1
    assert t_kernels.bounded(_machine(name)[0])
    # one sub-tile is the whole-tile scan itself
    text = _text(3 * L + 17, 7, False)
    want = t_kernels.mask_scan_reference(torch.from_numpy(text), m, W, L)
    assert np.array_equal(split_model([text], m, W, (1,))[1][0],
                          want.numpy())
