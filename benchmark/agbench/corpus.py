"""The benchmark's inputs, made from a seed in a few vectorised steps.

Copied from chip_smoke.py at commit fe63a388977a (make_corpus and its
word lists) and rewritten to build the whole text at once instead of
tiling a 4 MB template:

- a corpus is lines of `words_per_line` filler words joined by spaces,
  49 B a line on average with the default words;
- a fixed share of its lines (exactly one in `plant_every`, at places
  drawn from the seed) has one word replaced by a plant word;
- a buffer is a span of whole lines of the corpus, at a place drawn
  from the seed.

The seed moves where the plants fall and which words fill the lines,
never the number of lines or plants: only the byte count moves, by the
lengths of the words drawn (well under 0.1 % at 100 MB).
"""

from __future__ import annotations

import numpy as np

FILLER = (b"the", b"quick", b"brown", b"fox", b"pattern", b"search",
          b"world", b"lorem", b"ipsum", b"dolor", b"bibliography",
          b"string", b"grep", b"over", b"lazy", b"dog")
PLANTS = (b"hello", b"matching", b"matchng", b"Approximate",
          b"aproximate", b"approximately", b"HELLO")


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """The generator of one input stream of a seed; any whole number
    seeds it, however large."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def _vocab(words):
    """(bytes of every word back to back, start of each, length of each)"""
    lens = np.array([len(w) for w in words], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (np.frombuffer(b"".join(words), dtype=np.uint8), starts, lens)


def _assemble(tokens, words):
    """The bytes of a sequence of word ids (indices into words)."""
    flat, starts, lens = _vocab(words)
    tl = lens[tokens]
    ends = np.cumsum(tl)
    out_n = int(ends[-1]) if len(ends) else 0
    # output byte i of token t comes from flat[i + starts[t] - (its
    # first output byte)]
    shift = np.repeat(starts[tokens] - (ends - tl), tl)
    shift += np.arange(out_n, dtype=np.int64)
    return flat[shift]


def line_words(n_lines: int, seed: int, plants, plant_every: int,
               words_per_line: int = 8):
    """[n_lines, words_per_line] word ids into FILLER + plants: filler
    words drawn uniformly, and in n_lines // plant_every lines, drawn
    without replacement, one word (at a drawn place) replaced by a plant
    word drawn uniformly."""
    rng = rng_of(seed, 1)
    ids = rng.integers(0, len(FILLER), (n_lines, words_per_line))
    if plants and plant_every:
        n_plant = n_lines // plant_every
        rows = rng.choice(n_lines, n_plant, replace=False)
        cols = rng.integers(0, words_per_line, n_plant)
        ids[rows, cols] = len(FILLER) + rng.integers(0, len(plants), n_plant)
    return ids


def make_text(n_bytes: int, seed: int, plants=PLANTS,
              plant_every: int = 1000,
              words_per_line: int = 8) -> np.ndarray:
    """About n_bytes of lines (uint8), ending in a newline.

    The number of lines is n_bytes over the mean line length, so it is
    the same for every seed."""
    plants = tuple(plants)
    words = FILLER + plants
    mean_word = float(np.mean([len(w) for w in FILLER]))
    mean_line = words_per_line * (mean_word + 1)
    n_lines = max(1, int(n_bytes / mean_line))
    ids = line_words(n_lines, seed, plants, plant_every, words_per_line)
    SP, NL = len(words), len(words) + 1
    words = words + (b" ", b"\n")
    toks = np.empty((n_lines, 2 * words_per_line), dtype=np.int64)
    toks[:, 0::2] = ids
    toks[:, 1::2] = SP
    toks[:, -1] = NL
    toks = toks.reshape(-1)
    return _assemble(toks, words)


def buffer_spans(text: np.ndarray, n_buffers: int, size: int,
                 seed: int, stream: int) -> list:
    """n_buffers (start, end) spans of whole lines of text, each of at
    most size - 1 bytes (a buffer is a newline and then the span), at
    starts drawn from the seed."""
    rng = rng_of(seed, 10 + stream)
    nl = np.flatnonzero(text == 0x0A)
    starts = np.concatenate([[0], nl + 1])[:-1]
    spans = []
    for _ in range(n_buffers):
        hi = int(np.searchsorted(starts, len(text) - size, side="right"))
        s = int(starts[int(rng.integers(0, max(hi, 1)))])
        # the last newline within size - 1 bytes of s
        e = int(nl[int(np.searchsorted(nl, s + size - 2, side="right")) - 1]) + 1
        spans.append((s, e))
    return spans
