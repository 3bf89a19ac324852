"""The agrep command-line interface.

Thin wrapper over the library API, like reference main.c:32-97:
exit code = number of matches (-1 -> 255 on error, 2 on usage errors
via EXITONERROR).
"""

from __future__ import annotations

import sys

from .api import fileagrep
from .options import AgrepError
from .runtime.output import OutputOverflow


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        ret = fileagrep(argv)
    except AgrepError as e:
        # initial_value() zeroes EXITONERROR before any error can fire
        # (agrep.c:347,2076), so the reference CLI reports -1 -> 255
        from . import help as helpmod
        if getattr(e, "version", False):
            # agrep.c:2597-2601: leading newline + version to stdout,
            # then the -1 error return
            helpmod.print_version()
            return 255
        msg = str(e)
        if msg:
            print(msg, file=sys.stderr)
        if e.show_usage:
            helpmod.print_usage()
        if getattr(e, "late", False) and getattr(e, "verbose", 1) > 0:
            # exec()-stage conflicts: agrep_search still prints the
            # Grand Total line (agrep.c:3229)
            print("Grand Total: 0 match(es) found.")
        return 255
    except OutputOverflow:
        return 255
    except BrokenPipeError:
        return 0
    sys.stdout.flush()
    return ret & 0xFF




if __name__ == "__main__":
    sys.exit(main())
