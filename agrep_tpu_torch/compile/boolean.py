"""Boolean pattern splitting (reference asplit.c / putils.c).

Splits ``a;b;c`` / ``a,b,c`` flat booleans and the full ``{ } ~`` grammar

    E = {E} | ~a | ~{E} | E ; E | E , E | a

into a list of terminal patterns plus an evaluation tree.  When the split
succeeds, the query is executed by the multi-pattern record engine with a
per-record terminal-hit vector evaluated through the tree (asplit.c
eval_tree:341-365, vectorized here).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAXNUM_PAT = 16  # agrep.h:31


@dataclass
class BoolNode:
    op: str                     # 'leaf' | 'and' | 'or'
    negate: bool = False        # NOTPAT
    index: int = -1             # terminal index for leaves
    left: "BoolNode | None" = None
    right: "BoolNode | None" = None


@dataclass
class BoolSplit:
    terminals: list             # list[str] terminal patterns
    tree: BoolNode | None       # None for flat splits
    op: str                     # 'and' | 'or' | 'single' (flat)
    complex: bool = False
    negated_flat: list = field(default_factory=list)  # per-terminal NOT flags


class BoolParseError(Exception):
    pass


def is_complex_boolean(pattern: str) -> bool:
    """putils.c:5-33: mixed ,/; or any ~ makes it complex."""
    cur = ""
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            i += 2
        elif c == ",":
            if cur in (";", "~"):
                return True
            cur = ","
            i += 1
        elif c == ";":
            if cur in (",", "~"):
                return True
            cur = ";"
            i += 1
        elif c == "~":
            return True
        else:
            i += 1
    return False


def _tokenize(pattern: str):
    """putils.c get_token_bool: yields ('op', char) or ('a', text)."""
    i = 0
    n = len(pattern)
    while True:
        if i >= n or pattern[i] in "\n\0":
            yield ("e", "")
            return
        while i < n and pattern[i] in " \t":
            i += 1
        if i >= n or pattern[i] in "\n\0":
            yield ("e", "")
            return
        c = pattern[i]
        if c in ",;~{}":
            i += 1
            yield (c, c)
            continue
        buf = []
        while i < n and pattern[i] not in ",;~{}\n\0":
            if pattern[i] == "\\":
                buf.append(pattern[i])
                i += 1
                if i < n:
                    buf.append(pattern[i])
                    i += 1
            else:
                buf.append(pattern[i])
                i += 1
        yield ("a", "".join(buf))


class _TokenStream:
    def __init__(self, pattern: str):
        self.toks = list(_tokenize(pattern))
        self.pos = 0

    def next(self):
        t = self.toks[self.pos]
        if self.pos < len(self.toks) - 1:
            self.pos += 1
        return t

    def unget(self):
        self.pos -= 1


def _garble_leaf(text: str, depth: int, frames: dict) -> str:
    """aparse_tree's plain-terminal stack leak (asplit.c:239-260): the
    copy buffer zeroes [len+1] but never [len], so strcpy appends ONE
    byte of whatever the frame's buffer held there -- deterministically
    the residue of the PREVIOUS plain terminal parsed at the same
    recursion depth (aparse_tree frames at equal depth reuse the same
    stack slot; a fresh slot reads as NUL).  `{kernel;device},zebra`
    thus searches for "zebral" as its third terminal -- stable
    run-to-run (six-run probe), not heap noise."""
    buf = frames.setdefault(depth, bytearray(300))
    raw = text.encode("latin-1")
    L = len(raw)
    junk = buf[L] if L < len(buf) else 0
    out = text + (chr(junk) if junk else "")
    buf[:L] = raw
    if L + 1 < len(buf):
        buf[L + 1] = 0
    return out


def _parse_tree(ts: _TokenStream, terminals: list, depth: int = 0,
                frames: dict | None = None) -> BoolNode:
    if frames is None:
        frames = {}
    kind, text = ts.next()
    if kind == "{":
        t = _parse_tree(ts, terminals, depth + 1, frames)
        kind, _ = ts.next()
        if kind != "}":
            raise BoolParseError("parse error")
        return _infix_lookahead(ts, terminals, t, depth, frames)
    if kind == "~":
        kind, text = ts.next()
        if kind == "a":
            # the ~a leaf path NUL-terminates properly (asplit.c:189)
            t = _make_leaf(terminals, text, negate=True)
        elif kind == "{":
            t = _parse_tree(ts, terminals, depth + 1, frames)
            t.negate = not t.negate
            kind, _ = ts.next()
            if kind != "}":
                raise BoolParseError("parse error")
        else:
            raise BoolParseError("parse error")
        return _infix_lookahead(ts, terminals, t, depth, frames)
    if kind == "a":
        if not text:
            raise BoolParseError("empty term")
        n = _make_leaf(terminals, _garble_leaf(text, depth, frames))
        kind2, _ = ts.next()
        if kind2 == "}":
            ts.unget()
            return n
        if kind2 == "e":
            return n
        if kind2 in (",", ";"):
            right = _parse_tree(ts, terminals, depth + 1, frames)
            return BoolNode(op="and" if kind2 == ";" else "or",
                            left=n, right=right)
        raise BoolParseError("parse error")
    raise BoolParseError("parse error")


def _infix_lookahead(ts: _TokenStream, terminals: list, t: BoolNode,
                     depth: int, frames: dict) -> BoolNode:
    kind, _ = ts.next()
    if kind == "e":
        return t
    if kind in (",", ";"):
        right = _parse_tree(ts, terminals, depth + 1, frames)
        return BoolNode(op="and" if kind == ";" else "or", left=t, right=right)
    if kind == "}":
        ts.unget()
        return t
    raise BoolParseError("parse error")


def _make_leaf(terminals: list, text: str, negate: bool = False) -> BoolNode:
    if len(terminals) >= MAXNUM_PAT:
        raise BoolParseError("Pattern expression too large (> %d)" % MAXNUM_PAT)
    terminals.append(text)
    return BoolNode(op="leaf", negate=negate, index=len(terminals) - 1)


def split_pattern(pattern: str) -> BoolSplit | None:
    """asplit_pattern semantics.  Returns None when the pattern is not a
    splittable boolean (single plain term, or terms that are not simple),
    in which case the caller falls back to normal mask processing."""
    if is_complex_boolean(pattern):
        terminals: list = []
        try:
            tree = _parse_tree(_TokenStream(pattern), terminals)
        except BoolParseError:
            return None
        if not _terms_simple(terminals):
            return None
        return BoolSplit(terminals=terminals, tree=tree, op="complex",
                         complex=True)

    # flat split: strip unescaped braces first (asplit.c:304-313)
    stripped = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            stripped.append(c)
            if i + 1 < len(pattern):
                stripped.append(pattern[i + 1])
            i += 2
        elif c in "{}":
            i += 1
        else:
            stripped.append(c)
            i += 1
    flat = "".join(stripped)

    terminals = []
    op = None
    cur = []
    i = 0
    while i < len(flat):
        c = flat[i]
        if c == "\\":
            cur.append(c)
            if i + 1 < len(flat):
                cur.append(flat[i + 1])
            i += 2
            continue
        if c in ",;":
            this_op = "or" if c == "," else "and"
            if op is not None and op != this_op:
                return None  # mixed ops without braces: parse error path
            op = this_op
            if cur:
                terminals.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    if cur:
        terminals.append("".join(cur))

    if op is None:
        return None  # single plain term -> normal processing
    if len(terminals) > MAXNUM_PAT:
        # aparse_flat rejects the 17th terminal (asplit.c:95-98); the
        # caller then falls through to normal mask processing, which
        # reports the pattern as over-long
        import sys
        print("boolean expression has too many terms", file=sys.stderr)
        return None
    if not terminals or not _terms_simple(terminals):
        return None
    if len(terminals) >= MAXNUM_PAT:
        # asplit_terminal keeps the first 16 words and warns
        # (asplit.c:391-394)
        import sys
        print("Warning: too many words in pattern (> %d): ignoring..."
              % MAXNUM_PAT, file=sys.stderr)
    return BoolSplit(terminals=terminals, tree=None, op=op)


def _terms_simple(terminals: list) -> bool:
    """asplit_terminal runs checksg(term, D, 0) on each term and rejects
    the split if any term is non-simple (asplit.c:384-385)."""
    complex_chars = set(";,.*[]()<>|#{}~")
    for t in terminals:
        if not t:
            continue
        i = 0
        while i < len(t):
            c = t[i]
            if c == "\\":
                i += 2
                continue
            if c in complex_chars or c == "-":
                return False
            if c in "^$":
                break
            i += 1
    return True


def eval_tree_vec(node: BoolNode | None, op: str,
                  hits: np.ndarray) -> np.ndarray:
    """Vectorized eval_tree: hits is bool[n_records, n_terminals];
    returns bool[n_records]."""
    if node is None:
        if op == "and":
            return hits.all(axis=1)
        return hits.any(axis=1)
    if node.op == "leaf":
        res = hits[:, node.index]
    elif node.op == "and":
        res = eval_tree_vec(node.left, op, hits) & \
            eval_tree_vec(node.right, op, hits)
    else:
        res = eval_tree_vec(node.left, op, hits) | \
            eval_tree_vec(node.right, op, hits)
    if node.negate:
        res = ~res
    return res
