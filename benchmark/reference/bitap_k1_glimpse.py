"""Plain reference of bitap_k1_glimpse: `-1 -n matching` through
Query.search_buffer, every newline record of a buffer within one edit
of `matching`, printed with its line number in the buffer
(ref_lines)."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ref_lines import expected  # noqa: E402,F401
