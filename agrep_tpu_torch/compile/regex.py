"""Regular-expression compilation: Glushkov position automaton.

Reproduces the reference pipeline parse.c + follow.c + compute_next
(agrep.c:396-457): the r_pat source ".*(.(BODY).)" is parsed into
leaves with firstpos/lastpos/followpos, giving position-indexed
transition sets.  Bit mapping (re1, agrep.c:489-499): parse position p
occupies bit 1 << (M - p) where M is the mask-generator's position
count; position 0 is the leading ".*" (always on), position 1 the HEAD
dot, position M the TAIL dot whose bit (the LSB) is the match flag.

Reference quirk preserved: compute_next reads at most 10 followpos
entries per position (agrep.c:412), so followpos lists are truncated at
10 after ascending sort.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..options import AgrepError, PROGNAME

ASCII_MIN = 1
ASCII_MAX = 255  # parse.c wildcard spans all ascii (re.h ASCII_MAX)


class ReParseError(Exception):
    pass


@dataclass
class _Leaf:
    pos: int
    ranges: list          # [(lo, hi)] or None for EOS
    is_eos: bool = False


@dataclass
class _Node:
    op: str               # 'lit','cat','alt','star','opt'
    nullable: bool
    firstpos: frozenset
    lastpos: frozenset
    children: list = field(default_factory=list)
    leaf: _Leaf | None = None


class _Parser:
    """Recursive-descent parser over the r_pat string (parse.c:325-449
    grammar: literals, csets, '.', '(', ')', '*', '?', '|')."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0
        self.pos_cnt = 0
        self.leaves: list[_Leaf] = []

    def _leaf(self, ranges) -> _Node:
        lf = _Leaf(self.pos_cnt, ranges)
        self.pos_cnt += 1
        self.leaves.append(lf)
        fp = frozenset([lf.pos])
        return _Node("lit", False, fp, fp, leaf=lf)

    def _eos_leaf(self) -> _Node:
        lf = _Leaf(self.pos_cnt, None, is_eos=True)
        self.pos_cnt += 1
        self.leaves.append(lf)
        fp = frozenset([lf.pos])
        return _Node("lit", False, fp, fp, leaf=lf)

    def peek(self):
        return self.s[self.i] if self.i < len(self.s) else None

    def parse_cset(self):
        ranges = []
        if self.peek() in (None, "]"):
            raise ReParseError("empty cset")
        while self.peek() not in (None, "]"):
            ch = self.s[self.i]
            self.i += 1
            if ch == "-":
                raise ReParseError("invalid range")
            lo = ord(ch) & 0xFF
            if self.peek() is None:
                raise ReParseError("unterminated cset")
            if self.peek() == "-":
                self.i += 1
                nxt = self.peek()
                if nxt is None or nxt in ("-", "]") or ord(nxt) < lo:
                    raise ReParseError("invalid range")
                hi = ord(self.s[self.i]) & 0xFF
                self.i += 1
            else:
                hi = lo
            ranges.append((lo, hi))
        if self.peek() != "]":
            raise ReParseError("unterminated cset")
        self.i += 1
        return ranges

    def parse_re(self, end_tok):
        # Stack discipline mirrors parse.c:325-427: the *top* entry is
        # always the most recent atom, so postfix * and ? bind to it;
        # anything below the top gets condensed into one CAT node
        # (cat2 on stk->next when Size > 2).
        stack: list[_Node] = []

        def condense_below_top():
            if len(stack) > 2:
                r = stack.pop(-2)
                l = stack.pop(-2)
                stack.insert(-1, _cat(l, r))

        def push_atom(node: _Node):
            stack.append(node)
            condense_below_top()

        while True:
            c = self.peek()
            if c is None or c == ")":
                tok_is_end = (c is None and end_tok is None) or \
                             (c == ")" and end_tok == ")")
                if not tok_is_end:
                    raise ReParseError("unbalanced")
                if len(stack) >= 2:
                    r = stack.pop()
                    l = stack.pop()
                    stack.append(_cat(l, r))
                if not stack:
                    raise ReParseError("empty")
                return stack[-1]
            if c == ".":
                self.i += 1
                push_atom(self._leaf([(ASCII_MIN, ASCII_MAX)]))
            elif c == "[":
                self.i += 1
                push_atom(self._leaf(self.parse_cset()))
            elif c == "(":
                self.i += 1
                sub = self.parse_re(")")
                if self.peek() != ")":
                    raise ReParseError("unbalanced paren")
                self.i += 1
                push_atom(sub)
            elif c == "*":
                self.i += 1
                if not stack:
                    raise ReParseError("dangling *")
                stack.append(_wrap(stack.pop(), "star"))
            elif c == "?":
                self.i += 1
                if not stack:
                    raise ReParseError("dangling ?")
                stack.append(_wrap(stack.pop(), "opt"))
            elif c == "|":
                self.i += 1
                if len(stack) >= 2:
                    r = stack.pop()
                    l = stack.pop()
                    stack.append(_cat(l, r))
                if not stack:
                    raise ReParseError("dangling |")
                right = self.parse_re(end_tok)
                left = stack.pop()
                stack.append(_alt(left, right))
                return stack[-1]
            elif c == "\\":
                self.i += 1
                if self.peek() is None:
                    raise ReParseError("dangling escape")
                ch = ord(self.s[self.i]) & 0xFF
                self.i += 1
                push_atom(self._leaf([(ch, ch)]))
            else:
                self.i += 1
                push_atom(self._leaf([(ord(c) & 0xFF, ord(c) & 0xFF)]))


def _cat(l: _Node, r: _Node) -> _Node:
    first = l.firstpos | r.firstpos if l.nullable else l.firstpos
    last = l.lastpos | r.lastpos if r.nullable else r.lastpos
    return _Node("cat", l.nullable and r.nullable, first, last,
                 children=[l, r])


def _alt(l: _Node, r: _Node) -> _Node:
    return _Node("alt", l.nullable or r.nullable,
                 l.firstpos | r.firstpos, l.lastpos | r.lastpos,
                 children=[l, r])


def _wrap(child: _Node, op: str) -> _Node:
    return _Node(op, True, child.firstpos, child.lastpos,
                 children=[child])


def _followpos(root: _Node, npos: int):
    fpos = [set() for _ in range(npos)]

    def walk(n: _Node):
        if n.op == "star":
            for p in n.lastpos:
                fpos[p] |= n.firstpos
            walk(n.children[0])
        elif n.op == "cat":
            l, r = n.children
            for p in l.lastpos:
                fpos[p] |= r.firstpos
            walk(l)
            walk(r)
        elif n.op in ("alt", "opt"):
            for ch in n.children:
                walk(ch)
    walk(root)
    return fpos


@dataclass
class RegexAutomaton:
    m: int                    # matches maskgen M; EOS/TAIL bit is LSB
    follow_bits: np.ndarray   # uint32[33]: followpos of position p as bits
    head_bit: int             # bit of position 1 (the HEAD dot)
    pos_ranges: list          # per-position char ranges (for kernels)


def build_automaton(r_pat: str,
                    m_override: int | None = None) -> RegexAutomaton:
    """extend_re + parse + mk_followpos + the compute_next bit layout.

    m_override: the mask generator's position count.  Normally it
    equals the parser's count, but a '?' in the pattern gets a maskgen
    position while the parser treats it as an operator; the reference
    then runs with misaligned tables (compute_next uses the maskgen M
    for the bit base, agrep.c:405).  Passing maskgen's M reproduces
    that exactly."""
    src = ".*(" + r_pat + ")"
    p = _Parser(src)
    try:
        tree = p.parse_re(None)
    except ReParseError:
        raise AgrepError("%s: illegal regular expression" % PROGNAME)
    # append EOS (parse.c parse():434-449)
    eos = p._eos_leaf()
    tree = _cat(tree, eos)
    npos = p.pos_cnt
    num_pos = npos - 1         # init() returns pos_cnt after decrement
    if num_pos <= 0:
        raise AgrepError("%s: illegal regular expression" % PROGNAME)
    if num_pos > 30:
        raise AgrepError("%s: regular expression too long" % PROGNAME)

    fpos = _followpos(tree, npos)
    # Parse position p maps to bit 1 << (M - p): position 0 (the '.*')
    # is the top bit 1 << M, the TAIL dot is normally the LSB = the
    # match flag; EOS holds no bit.
    M = num_pos - 1 if m_override is None else m_override
    follow_bits = np.zeros(33, dtype=np.uint32)
    for pnum in range(min(num_pos, M)):
        entries = sorted(x for x in fpos[pnum] if 0 < x <= M)
        entries = entries[:10]        # compute_next j < 10 quirk
        bits = 0
        for q in entries:
            bits |= 1 << (M - q)
        follow_bits[pnum] = bits
    head_bit = 1 << (M - 1) if M >= 1 else 1

    pos_ranges = []
    for pnum in range(num_pos):
        lf = p.leaves[pnum]
        pos_ranges.append(lf.ranges or [])
    return RegexAutomaton(m=M, follow_bits=follow_bits,
                          head_bit=head_bit, pos_ranges=pos_ranges)
