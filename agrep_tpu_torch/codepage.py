"""Codepage / case-folding tables.

Reproduces the reference's codepage layer (codepage.c, codepage.h:19-48):
three codepages (437, 850, ISO-8859-1), each giving per character

    lower_1  -- case fold within the codepage            (-i)
    lower_2  -- fold + map ISO accents to nearest ASCII  (-ia)
    lower_3  -- class fold: letters->'a', digits->'1',
                other printables->'#', controls kept     (-i#)

plus a `metasymb` marker for bytes that act as pattern metasymbols.
The numeric tables live in data/codepages.py (generated from
the reference's factual table data by tools/gen_codepage.py).

Fold table selection follows reference agrep.c:2742-2848: outside EMX,
get_current_codepage() is -1, so the default codepage is ISO-8859-1
(number 8859) unless -CP overrides it; metasymbol bytes are never
folded (LUT[i]=i, agrep.c:2845).
"""

from __future__ import annotations

import numpy as np

from .data import codepages as _data

# Pattern metasymbol byte values for the non-EMX build (agrep.h:66-85).
WORDB = 133
LPARENT = 134
RPARENT = 135
LRANGE = 136
RRANGE = 137
LANGLE = 138
RANGLE = 139
NOTSYM = 140
WILDCD = 141
ORSYM = 142
ORPAT = 143
ANDPAT = 144
STAR = 145
HYPHEN = 129
NOCARE = 130
NNLINE = 131

_TABLES = {437: _data.CP437, 850: _data.CP850, 8859: _data.CP8859}

DEFAULT_CODEPAGE = 8859


def resolve_codepage(requested: int | None) -> int:
    """Map a -CP argument (or None) to a supported codepage number.

    Unknown/undetectable codepages fall back to ISO-8859-1
    (reference agrep.c:2747-2760).
    """
    if requested in _TABLES:
        return requested
    return DEFAULT_CODEPAGE


def metasymbol_bytes(codepage: int) -> list[int]:
    """Byte values flagged as metasymbols in this codepage's table."""
    table = _TABLES[resolve_codepage(codepage)]
    return [i for i in range(256) if table[i][3] > 0]


def build_lut(codepage: int, mapping: str | None) -> np.ndarray:
    """Build the 256-entry fold LUT for a -i mapping.

    mapping: None (case sensitive), 'i' (-i), 'a' (-ia), '#' (-i#).
    Metasymbol bytes are preserved unfolded (agrep.c:2835-2848).
    """
    codepage = resolve_codepage(codepage)
    table = _TABLES[codepage]
    lut = np.arange(256, dtype=np.uint8)
    col = {"i": 0, "a": 1, "#": 2}.get(mapping)
    if col is not None:
        for i in range(256):
            lut[i] = table[i][col]
    for i in range(256):
        if table[i][3] > 0:
            lut[i] = i
    return lut


def isupper_ascii(c: int) -> bool:
    return ord("A") <= c <= ord("Z")


def tolower_ascii(c: int) -> int:
    return c + 32 if isupper_ascii(c) else c


def build_tr() -> np.ndarray:
    """The sgrep fast path's TR fold table (sgrep.c char_tr).

    In the reference's Linux build the NOUPPER guard is commented out
    (sgrep.c:226-236), so the simple-pattern engines always fold ASCII
    upper case to lower case.  This is observable, pinned behaviour.
    """
    tr = np.arange(256, dtype=np.uint8)
    for i in range(ord("A"), ord("Z") + 1):
        tr[i] = i + 32
    return tr
