"""Query compilation: pattern string -> CompiledQuery.

Pipeline (mirrors reference semantics, SURVEY.md section 2.1):

    classify   -- is this a "simple" pattern? which engine class?
                  (reference checksg.c)
    pattern    -- user syntax -> internal meta-byte form + delimiter
                  augmentation (reference preproce.c)
    masks      -- bit-parallel tables for the shift-or machine
                  (reference maskgen.c)
    query      -- assemble the immutable CompiledQuery object
"""

from .query import CompiledQuery, compile_query

__all__ = ["CompiledQuery", "compile_query"]
