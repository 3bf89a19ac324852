"""Host runtime: stream preparation, record extraction, byte-exact
output formatting, and the per-search executor.

The scan itself (ops) only produces event words; everything
here is host-side bookkeeping that reproduces the reference's output
byte-for-byte (agrep.c output():3805-3956, sgrep.c s_output:1275-1483,
exec():3332-3752).
"""
