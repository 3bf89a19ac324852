"""Option parsing and option-compatibility checks.

Mirrors the reference's hand-rolled single-pass parser (agrep.c:2058-3009)
and the conflict matrix (compat.c:24-109).  The reference communicates via
~80 globals; here everything lands in one Options dataclass.

Flag surface (reference help page agrephlp.c:123-145):
  -#        number of errors (0..8)
  -b -c -d -e -f -g -h -i[0a#] -k -l -m -n -o -p -q -r -s -t -u -v -w
  -x -y -z -A -B -CP# -D# -G -H -I# -L[o:t:p] -M -O -P -S# -V[0-5] -Z
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

MAXPAT = 256         # agrep.h:33
MAX_ERRORS = 8       # MaxError, agrep.h:44
MAX_DELIMIT = 16     # MaxDelimit, agrep.h:46
MAXDELIM = 8         # compiled delimiter cap, agrep.h:35
AGREP_ERROR = 123    # agrep.h:173

PROGNAME = "agrep"


class AgrepError(Exception):
    """Raised for user-level errors; the CLI maps this to exit 255
    (initial_value zeroes EXITONERROR before any error can fire)."""

    def __init__(self, message: str, show_usage: bool = False,
                 version: bool = False, late: bool = False,
                 verbose: int = 1):
        super().__init__(message)
        self.show_usage = show_usage
        self.version = version
        # `late` errors fire inside exec() (compat.c conflicts): the
        # reference still prints the Grand Total line after exec
        # returns -1 (agrep.c:3229)
        self.late = late
        self.verbose = verbose


@dataclass
class Options:
    # errors / costs
    D: int = 0
    approx: bool = False          # APPROX: a -# flag was given
    cost_insert: int = 1          # I  (-I#)
    cost_subst: int = 1           # S  (-S#)
    cost_delete: int = 1          # DD (-D#)
    jump: bool = False            # JUMP: any of -I/-S/-D given
    supersequence: bool = False   # -p: insertion cost 0

    # matching modes
    invert: bool = False          # -v
    wordbound: bool = False       # -w
    wholeline: bool = False       # -x
    nocase: str | None = None     # None | 'i' | 'a' | '#'  (-i/-ia/-i#; -i0 resets)
    constant: bool = False        # -k
    bestmatch: bool = False       # -B
    noprompt: bool = False        # -y

    # records
    delimiter: str | None = None  # -d raw argument (user syntax)
    outtail: bool = False         # -t
    noouttail: bool = False       # -o

    # output
    count: bool = False           # -c
    filename_only: bool = False   # -l
    no_filename: bool = False     # -h
    linenum: bool = False         # -n
    bytecount: bool = False       # -b
    printoffset: bool = False     # -q
    printrecord: bool = True      # off with -u
    silent: bool = False          # -s
    fileout: bool = False         # -G
    nooutputzero: bool = False    # -z
    printpattern: bool = False    # -P
    printfilenumber: bool = False # -g
    always_filename: bool = False # -A
    post_filter: bool = False     # -O
    multi_output: bool = False    # -M
    verbose: int = 1              # -V0..-V5

    # limits (-L o:t:p)
    limit_output: int = 0
    limit_total_file: int = 0
    limit_per_file: int = 0

    # multi-pattern
    pat_file: str | None = None   # -f FILE
    pat_buffer: str | None = None # -m PATTERNS

    # misc
    recursive: bool = False       # -r
    codepage: int | None = None   # -CP N
    comp_dir: str | None = None   # -H DIR (tcompress seam; stubbed)

    warnings: list = field(default_factory=list)


def _warn(opts: Options, msg: str) -> None:
    opts.warnings.append(msg)
    print(msg, file=sys.stderr)


def parse_args(argv: list[str], env: dict | None = None):
    """Parse an agrep command line (without argv[0]).

    Returns (Options, pattern, files).  AGREPOPTS is prepended
    (agrep.c:2107).  Raises AgrepError on bad usage.
    """
    env = os.environ if env is None else env
    opts = Options()
    # Note: the non-EMX reference only *displays* AGREPOPTS, it does not
    # actually prepend it (the _envargs call is EMX-only, agrep.c:2101).
    # We pin that behaviour: the variable is read but not applied.

    args = list(argv)
    pattern: str | None = None
    i = 0

    def need_arg(flagname: str, what: str):
        nonlocal i
        if i + 1 >= len(args):
            raise AgrepError(
                "%s: the -%s option must have a %s argument"
                % (PROGNAME, flagname, what))
        i += 1
        return args[i]

    while i < len(args) and args[i].startswith("-") and pattern is None:
        group = args[i][1:]
        if group == "":
            break  # bare '-' -> treated as pattern below
        j = 0
        quit_group = False
        while not quit_group and j < len(group):
            c = group[j]
            rest = group[j + 1:]
            if c == "z":
                opts.nooutputzero = True
            elif c == "c":
                opts.count = True
            elif c == "C":
                if rest.startswith("P"):
                    arg = rest[1:] or need_arg("CP", "codepage number")
                    try:
                        opts.codepage = int(arg)
                    except ValueError:
                        opts.codepage = 0
                    quit_group = True
                else:
                    print("no such option: -C")
            elif c == "s":
                opts.silent = True
            elif c == "p":
                opts.supersequence = True
                opts.cost_insert = 0
            elif c == "P":
                opts.printpattern = True
            elif c == "x":
                if opts.wordbound:
                    raise AgrepError(
                        "%s: illegal option combination (-x and -w)" % PROGNAME)
                opts.wholeline = True
            elif c == "b":
                opts.bytecount = True
            elif c == "q":
                opts.printoffset = True
            elif c == "u":
                opts.printrecord = False
            elif c == "g":
                opts.printfilenumber = True
            elif c == "L":
                arg = rest or need_arg("L", "output-limit")
                parts = (arg.split(":") + ["0", "0", "0"])[:3]
                try:
                    vals = [int(p) if p else 0 for p in parts]
                except ValueError:
                    vals = [0, 0, 0]
                opts.limit_output, opts.limit_total_file, opts.limit_per_file = vals
                if any(v < 0 for v in vals):
                    raise AgrepError(
                        "%s: invalid output limit %s" % (PROGNAME, arg))
                quit_group = True
            elif c == "d":
                arg = rest if rest else need_arg("d", "delimiter")
                if len(arg) > MAX_DELIMIT:
                    raise AgrepError(
                        "%s: delimiter pattern too long (has > %d chars)"
                        % (PROGNAME, MAX_DELIMIT))
                opts.delimiter = arg
                # single-char ^/$/\n delimiters force tail output
                # (agrep.c:2289)
                if len(arg) == 1 and arg in ("\n", "$", "^"):
                    opts.outtail = True
                quit_group = True
            elif c == "H":
                opts.comp_dir = rest or need_arg("H", "directory name")
                quit_group = True
            elif c == "e":
                arg = rest if rest else need_arg("e", "pattern")
                pattern = ("\\" + arg) if arg.startswith("-") else arg
                quit_group = True
            elif c == "k":
                opts.constant = True
                arg = rest if rest else need_arg("k", "pattern")
                pattern = arg
                if i + 1 < len(args) and args[i + 1].startswith("-"):
                    raise AgrepError(
                        "%s: -k should be the last option in the command"
                        % PROGNAME)
                quit_group = True
            elif c == "f":
                if opts.pat_file is not None:
                    raise AgrepError("%s: multiple -f options" % PROGNAME)
                if opts.pat_buffer is not None:
                    raise AgrepError(
                        "%s: -f and -m are incompatible" % PROGNAME)
                arg = need_arg("f", "pattern file")
                if not os.path.exists(arg):
                    raise AgrepError(
                        "%s: can't open pattern file for reading: %s"
                        % (PROGNAME, arg))
                opts.pat_file = arg
                quit_group = True
            elif c == "m":
                if opts.pat_buffer is not None:
                    raise AgrepError("%s: multiple -m options" % PROGNAME)
                if opts.pat_file is not None:
                    raise AgrepError(
                        "%s: -f and -m are incompatible" % PROGNAME)
                arg = need_arg("m", "pattern buffer")
                if arg:
                    opts.pat_buffer = arg
                quit_group = True
            elif c == "h":
                opts.no_filename = True
            elif c == "i":
                if rest.startswith("0"):
                    j += 1
                    opts.nocase = None
                elif rest.startswith("a"):
                    j += 1
                    opts.nocase = "a"
                elif rest.startswith("#"):
                    j += 1
                    opts.nocase = "#"
                else:
                    opts.nocase = "i"
            elif c == "l":
                opts.filename_only = True
            elif c == "n":
                opts.linenum = True
            elif c == "r":
                opts.recursive = True
            elif c == "v":
                opts.invert = True
            elif c == "V":
                nxt = rest[:1]
                if nxt and nxt in "012345":
                    j += 1
                    opts.verbose = 2 if nxt == "V" else int(nxt)
                elif nxt == "V":
                    j += 1
                    opts.verbose = 2
                elif nxt == "":
                    raise AgrepError("", version=True)
            elif c == "t":
                opts.outtail = True
            elif c == "o":
                opts.noouttail = True
            elif c == "B":
                opts.bestmatch = True
            elif c == "w":
                if opts.wholeline:
                    raise AgrepError(
                        "%s: illegal option combination (-w and -x)" % PROGNAME)
                opts.wordbound = True
            elif c == "y":
                opts.noprompt = True
            elif c == "I":
                opts.cost_insert = _atoi(rest)
                opts.jump = True
                quit_group = True
            elif c == "S":
                opts.cost_subst = _atoi(rest)
                opts.jump = True
                quit_group = True
            elif c == "D":
                opts.cost_delete = _atoi(rest)
                opts.jump = True
                quit_group = True
            elif c == "G":
                opts.fileout = True
                opts.count = True
            elif c == "A":
                opts.always_filename = True
            elif c == "O":
                # reference falls through -O -> -M -> -Z (agrep.c:2707-2713)
                opts.post_filter = True
                opts.multi_output = True
            elif c == "M":
                opts.multi_output = True
            elif c == "Z":
                pass
            elif c.isdigit():
                opts.approx = True
                opts.D = _atoi(group[j:])
                if opts.D > MAX_ERRORS:
                    raise AgrepError(
                        "%s: the maximum number of errors is %d"
                        % (PROGNAME, MAX_ERRORS))
                quit_group = True
            else:
                raise AgrepError(
                    "%s: illegal option  -%s" % (PROGNAME, c),
                    show_usage=True)
            j += 1
        i += 1

    if opts.noouttail:
        opts.outtail = False

    # pattern from positional arg unless -e/-k/-f/-m supplied it
    rest_args = args[i:]
    if pattern is None and opts.pat_file is None and opts.pat_buffer is None:
        if not rest_args:
            raise AgrepError("", show_usage=True)
        pattern = rest_args[0]
        rest_args = rest_args[1:]

    files = rest_args

    if opts.filename_only and opts.no_filename:
        _warn(opts, "%s: -h and -l options are mutually exclusive" % PROGNAME)
    if opts.count and (opts.filename_only or opts.no_filename):
        opts.filename_only = False
        if not opts.fileout:
            opts.no_filename = False

    if pattern is not None:
        pattern = _escape_bare_pattern(pattern, opts)
        if len(pattern) > MAXPAT - 1:
            # agrep_search's buffer-fit check (agrep.c:3001-3005) with
            # pattern_len = MAXPAT; M counts the dash-escaped pattern.
            # The reference already corrupted Pattern[MAXPAT] by this
            # point and segfaults past ~260 chars -- we always report
            # the intended diagnostic (docs/CONFORMANCE.md)
            raise AgrepError("%s: pattern '%s' does not fit in "
                             "specified buffer" % (PROGNAME, pattern))

    return opts, pattern, files


def _atoi(s: str) -> int:
    """C atoi: leading integer prefix, else 0."""
    s = s.strip()
    out = ""
    for idx, ch in enumerate(s):
        if ch.isdigit() or (idx == 0 and ch in "+-"):
            out += ch
        else:
            break
    try:
        return int(out)
    except ValueError:
        return 0


def _escape_bare_pattern(pattern: str, opts: Options) -> str:
    """Escape un-bracketed '-' in the pattern (agrep.c:2980-2999),
    and warn about metasymbol bytes."""
    from . import codepage as cp

    table_meta = set(cp.metasymbol_bytes(cp.resolve_codepage(opts.codepage)))
    out = []
    seenlsq = False
    i = 0
    warned = False
    while i < len(pattern):
        ch = pattern[i]
        o = ord(ch) & 0xFF
        if o in table_meta and not warned:
            # the reference BREAKS the whole escape loop at the first
            # metasymbol byte (agrep.c:2985-2987): the rest of the
            # pattern keeps its bare dashes
            _warn(opts, "Warning: pattern has some meta-characters "
                        "interpreted by agrep!")
            warned = True
            out.append(pattern[i:])
            break
        elif ch == "\\":
            out.append(ch)
            if i + 1 < len(pattern):
                i += 1
                out.append(pattern[i])
        elif ch == "[":
            seenlsq = True
            out.append(ch)
        elif ch == "]":
            seenlsq = False
            out.append(ch)
        elif ch == "-" and not seenlsq:
            out.append("\\-")
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def compat_check(opts: Options, has_multi: bool) -> None:
    """The option-conflict matrix (compat.c:24-109).

    Mutates opts (some conflicts just disable a flag with a warning),
    raises AgrepError for hard conflicts.
    """
    if opts.bestmatch and (opts.count or opts.filename_only or opts.approx
                           or opts.pat_file is not None):
        opts.bestmatch = False
        _warn(opts, "%s: -B option ignored when -c, -l, -f, or -# is on"
              % PROGNAME)
    if opts.count and opts.linenum:
        opts.linenum = False
        _warn(opts, "%s: -n option ignored with -c" % PROGNAME)
    if has_multi:
        if opts.approx and opts.D > 0:
            _warn(opts, "%s: approximate matching is not supported with -f "
                        "option" % PROGNAME)
        if opts.linenum:
            raise AgrepError("%s: -f and -n are not compatible" % PROGNAME,
                             late=True, verbose=opts.verbose)
    if opts.multi_output and opts.linenum:
        raise AgrepError("%s: -M and -n are not compatible" % PROGNAME,
                         late=True, verbose=opts.verbose)
    if opts.jump:
        if opts.cost_insert == 0 or opts.cost_subst == 0 or opts.cost_delete == 0:
            raise AgrepError("%s: the error cost cannot be 0" % PROGNAME,
                             late=True, verbose=opts.verbose)
    if opts.delimiter is not None and opts.wholeline:
        raise AgrepError("%s: -d and -x are not compatible" % PROGNAME,
                         late=True, verbose=opts.verbose)
    if opts.invert and has_multi and opts.multi_output:
        raise AgrepError("%s: -v and -M are not compatible" % PROGNAME,
                         late=True, verbose=opts.verbose)
