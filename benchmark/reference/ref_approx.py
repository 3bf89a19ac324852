"""Plain approximate matching of a pattern against every line of a text.

The pattern is a regular expression of literal bytes, classes `[...]`,
the dot, `*`, `+`, `?`, alternation `|` and groups `(...)`, made into a
position (Glushkov) automaton: one state for the start and one for each
byte position of the pattern.  A line matches when some substring of it
is within k edits of a word of the pattern, every insertion, deletion
and substitution costing one.  The sets of states reached with 0..k
edits are carried for all lines at once, one column of the text at a
time, as bit masks (NumPy, no other dependency).

For each column, with S_j the states reached with j edits before the
byte b and N_j after it:
    N_0 = follow(S_0) & class(b) | start
    N_j = follow(S_j) & class(b)        (a match)
        | S_{j-1}                       (b inserted)
        | follow(S_{j-1})               (b in place of a pattern byte)
        | follow(N_{j-1})               (a pattern byte left out)
        | start
and before the first byte S_j = start | follow(S_{j-1}).  The line
matches when some N_k (or S_k before its first byte) holds a final
state.
"""

from __future__ import annotations

import numpy as np


class Regex:
    """A position automaton: follow[p] the states after state p,
    classes[p] the bytes of position p (p >= 1; state 0 is the start),
    final the mask of the states that end a word."""

    def __init__(self, pattern: bytes):
        self.src = pattern
        self.classes = [None]
        self._i = 0
        tree = self._alt()
        if self._i != len(pattern):
            raise ValueError("unbalanced pattern %r" % pattern)
        n = len(self.classes)
        if n > 63:
            raise ValueError("more than 62 positions")
        self.n = n
        follow = [0] * n
        nullable, first, last = self._walk(tree, follow)
        follow[0] = first
        self.follow = follow
        self.final = last | (1 if nullable else 0)

    # --- parser: alt := cat ('|' cat)* ; cat := rep* ; rep := atom [*+?]
    def _peek(self):
        return self.src[self._i] if self._i < len(self.src) else None

    def _alt(self):
        node = self._cat()
        while self._peek() == ord("|"):
            self._i += 1
            node = ("alt", node, self._cat())
        return node

    def _cat(self):
        node = ("eps",)
        while self._peek() is not None and self._peek() not in b"|)":
            node = ("cat", node, self._rep())
        return node

    def _rep(self):
        node = self._atom()
        while self._peek() is not None and self._peek() in b"*+?":
            node = ({ord("*"): "star", ord("+"): "plus",
                     ord("?"): "opt"}[self._peek()], node)
            self._i += 1
        return node

    def _atom(self):
        c = self._peek()
        self._i += 1
        if c == ord("("):
            node = self._alt()
            if self._peek() != ord(")"):
                raise ValueError("unbalanced pattern %r" % self.src)
            self._i += 1
            return node
        if c == ord("["):
            members = set()
            neg = self._peek() == ord("^")
            if neg:
                self._i += 1
            while self._peek() != ord("]"):
                a = self._peek()
                self._i += 1
                if self._peek() == ord("-") and self.src[self._i + 1] != ord("]"):
                    b = self.src[self._i + 1]
                    self._i += 2
                    members.update(range(a, b + 1))
                else:
                    members.add(a)
            self._i += 1
            if neg:
                members = set(range(256)) - members - {0x0A}
            return self._pos(members)
        if c == ord("."):
            return self._pos(set(range(256)) - {0x0A})
        if c == ord("\\"):
            c = self._peek()
            self._i += 1
        return self._pos({c})

    def _pos(self, members):
        self.classes.append(frozenset(members))
        return ("pos", len(self.classes) - 1)

    def _walk(self, node, follow):
        """(nullable, first mask, last mask) of node, filling follow."""
        kind = node[0]
        if kind == "eps":
            return True, 0, 0
        if kind == "pos":
            return False, 1 << node[1], 1 << node[1]
        if kind == "alt":
            n1, f1, l1 = self._walk(node[1], follow)
            n2, f2, l2 = self._walk(node[2], follow)
            return n1 or n2, f1 | f2, l1 | l2
        if kind == "cat":
            n1, f1, l1 = self._walk(node[1], follow)
            n2, f2, l2 = self._walk(node[2], follow)
            for p in _bits(l1):
                follow[p] |= f2
            return (n1 and n2, f1 | (f2 if n1 else 0),
                    l2 | (l1 if n2 else 0))
        n1, f1, l1 = self._walk(node[1], follow)
        if kind in ("star", "plus"):
            for p in _bits(l1):
                follow[p] |= f1
        return (n1 or kind != "plus"), f1, l1


def _bits(mask: int):
    p = 0
    while mask:
        if mask & 1:
            yield p
        mask >>= 1
        p += 1


class Tables:
    """The automaton as lookup tables: follow of a mask one byte of the
    mask at a time, and each text byte's mask of positions."""

    def __init__(self, rx: Regex):
        self.rx = rx
        self.n_chunks = -(-rx.n // 8)
        self.follow = np.zeros((self.n_chunks, 256), dtype=np.uint64)
        for c in range(self.n_chunks):
            for v in range(256):
                m = 0
                for b in _bits(v):
                    p = 8 * c + b
                    if p < rx.n:
                        m |= rx.follow[p]
                self.follow[c, v] = m
        self.cmask = np.zeros(256, dtype=np.uint64)
        for p in range(1, rx.n):
            for b in rx.classes[p]:
                self.cmask[b] |= np.uint64(1 << p)
        self.final = np.uint64(rx.final)

    def follow_of(self, s):
        out = self.follow[0][(s & np.uint64(0xFF)).astype(np.intp)]
        for c in range(1, self.n_chunks):
            out |= self.follow[c][((s >> np.uint64(8 * c))
                                   & np.uint64(0xFF)).astype(np.intp)]
        return out

    def follow_int(self, s: int) -> int:
        m = 0
        for p in _bits(s):
            m |= self.rx.follow[p]
        return m


def _initial(tb: Tables, k: int) -> list:
    """S_0..S_k before a line's first byte."""
    init = [1]
    for j in range(1, k + 1):
        init.append(1 | tb.follow_int(init[j - 1]))
    return init


def matches_empty(pattern: bytes, k: int) -> bool:
    """Whether the empty line is within k edits of a word of the
    pattern (then every line matches)."""
    tb = Tables(Regex(pattern))
    return bool(_initial(tb, k)[k] & int(tb.final))


class Dfa:
    """The sets S_0..S_k as one state of a deterministic machine, its
    states and moves found as the text reaches them.  Text bytes with
    the same mask of positions share a column of the move table; a state
    whose S_k holds a final state has been reached by a match and keeps
    itself whatever follows."""

    def __init__(self, tb: Tables, k: int):
        self.tb, self.k = tb, k
        masks, self.byte_class = np.unique(tb.cmask, return_inverse=True)
        self.byte_class = self.byte_class.astype(np.int64)
        self.class_mask = [int(m) for m in masks]
        self.n_class = len(self.class_mask)
        self.final = int(tb.final)
        self.follow_memo: dict = {}
        self.states: list = []
        self.index: dict = {}
        self.accept = np.zeros(0, dtype=bool)
        self.move = np.full((0, self.n_class), -1, dtype=np.int64)
        self.start = self._id(tuple(_initial(tb, k)))

    def _follow(self, s: int) -> int:
        f = self.follow_memo.get(s)
        if f is None:
            f = self.follow_memo[s] = self.tb.follow_int(s)
        return f

    def _id(self, sets: tuple) -> int:
        i = self.index.get(sets)
        if i is None:
            i = self.index[sets] = len(self.states)
            self.states.append(sets)
            if i >= len(self.accept):
                grow = max(64, 2 * len(self.accept))
                self.accept = np.concatenate(
                    [self.accept, np.zeros(grow, dtype=bool)])
                self.move = np.concatenate(
                    [self.move, np.full((grow, self.n_class), -1,
                                        dtype=np.int64)])
            self.accept[i] = bool(sets[self.k] & self.final)
        return i

    def _step(self, i: int, c: int) -> int:
        if self.accept[i]:
            return i
        S, cm, f = self.states[i], self.class_mask[c], self._follow
        new = [(f(S[0]) & cm) | 1]
        for j in range(1, self.k + 1):
            new.append((f(S[j]) & cm) | S[j - 1] | f(S[j - 1])
                       | f(new[j - 1]) | 1)
        return self._id(tuple(new))

    def advance(self, ids: np.ndarray, cls: np.ndarray) -> np.ndarray:
        """The states after one byte of class cls from states ids."""
        code = ids * self.n_class + cls
        nxt = self.move.reshape(-1)[code]
        missing = nxt < 0
        if missing.any():
            for x in np.unique(code[missing]).tolist():
                i, c = divmod(x, self.n_class)
                self.move[i, c] = self._step(i, c)
            nxt = self.move.reshape(-1)[ids * self.n_class + cls]
        return nxt


def line_matches(text: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                 pattern: bytes, k: int) -> np.ndarray:
    """A boolean a line: whether line i (text[starts[i]:starts[i] +
    lens[i]], its newline left out) holds a substring within k edits of
    a word of the pattern."""
    dfa = Dfa(Tables(Regex(pattern)), k)
    hit = np.zeros(len(starts), dtype=bool)
    if dfa.accept[dfa.start]:
        hit[:] = True
        return hit
    order = np.argsort(-lens, kind="stable")
    s_sorted = starts[order]
    l_sorted = lens[order]
    ids = np.full(len(order), dfa.start, dtype=np.int64)
    maxlen = int(l_sorted[0]) if len(order) else 0
    # lines in length order: the lines still running at column c are a
    # prefix of the order
    active = np.searchsorted(-l_sorted, -np.arange(1, maxlen + 1),
                             side="right")
    text_class = dfa.byte_class.astype(np.uint8)[text]
    at = s_sorted.copy()
    for c in range(maxlen):
        n = int(active[c])
        ids[:n] = dfa.advance(ids[:n], text_class[at[:n]])
        at[:n] += 1
    hit[order] = dfa.accept[ids]
    return hit
