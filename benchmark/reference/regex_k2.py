"""Plain reference of regex_k2: `-2 'appro[a-z]*mat(e|ion)'` through
Query.search_buffer, every line of a buffer within two edits of a word
of the expression, printed as it stands (ref_lines)."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ref_lines import expected  # noqa: E402,F401
