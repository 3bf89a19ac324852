"""Help and version output (reference agrephlp.c:75-295).

The six-page interactive help is reproduced byte-for-byte from the
reference (agrephlp.c:100-295), including the navigation loop
(userw/compugoto macros: keys 1-6 jump, q/Q/- navigate, anything else
advances; EOF walks pages 1..6 then exits).  Only the first banner
line differs: the reference embeds its compile date
(AGREP_VERSION_STRING), which can never be byte-stable -- documented
divergence."""

import os
import sys
import time

from .version import __version__, REFERENCE_VERSION

BANNER = ("AGREP-TPU %s (capability surface of %s). "
          "Wu/Manber bit-parallel matching, TPU-native rebuild."
          % (__version__, REFERENCE_VERSION))

ONE_LINE = (
    "\nAGREP [-#cdehi[a|#]klnprstvwxyABDGIRS]"
    " [-f patternfile] [-H dir] pattern [files]")

_PAGE1 = '\n\n           Approximate Pattern Matching GREP -- Get Regular Expression\nUsage:\nAGREP [-#cdehi[a|#]klnprstvwxyABDGIRS] [-f patternfile] [-H dir] pattern [files]\n-#  find matches with at most # errors     -A  always output filenames\n-b  print byte offset of match\n-c  output the number of matched records   -B  find best match to the pattern\n-d  define record delimiter                -Dk deletion cost is k\n-e  for use when pattern begins with -     -G  output the files with a match\n-f  name of file containing patterns       -Ik insertion cost is k\n-h  do not display file names              -Sk substitution cost is k\n-i  case-insensitive search; ISO <> ASCII  -ia ISO chars mapped to lower ASCII\n-i# digits-match-digits, letters-letters   -i0 case-sensitive search\n-k  treat pattern literally - no meta-characters\n-l  output the names of files that contain a match\n-n  print line numbers of matches  -q print buffer byte offsets\n-p  supersequence search                   -CP 850|437 set codepage\n-r  recurse subdirectories (UNIX style)    -s silent\n-t  for use when delimiter is at the end of records\n-v  output those records without matches   -V[012345V] version / verbose more\n-w  pattern has to match as a word: "win" will not match "wind"\n-u  unterdruecke record output             -x  pattern must match a whole line\n-y  suppresses the prompt when used with -B best match option\n@listfile  use the filenames in listfile                              <1>23456Q'

_PAGE2 = '\nAGREP [-#cdehi[a|#]klnprstvwxyABDGIRS] [-f patternfile] [-H dir] pattern [files]\nThe pattern MUST BE ENCLOSED in "DOUBLE QUOTES" if it contains one of the\nfollowing METASYMBOLS. Good practice is always to include it in double quotes.\n\nMETASYMBOLS:\n\\z          turns off any special meaning of character z (\\# matches #)\n^           begin-of-line symbol\n$           end-of-line symbol\n.           matches any single character (except newline)\n#           matches any number > 0 of arbitrary characters\n(a)*        matches zero or more instances of preceding token a (Kleene closure)\na(a)*       matches one or more instances of preceding token a\n            (Use this as replacement for (a)+ which is not implemented yet.)\n\n[b-dq-tz]   matches characters b c d q r s t z\n[^b-diq-tz] matches all characters EXCEPT b c d i q r s t z\nab|cd       matches "ab" OR "cd"\n<abcd>      matches exactly, no errors allowed in string "abcd"\n            (overrides the -1 option)\n\ncat,dog     matches records having "cat" OR "dog"\ncat;dog     matches records having "cat" AND "dog"\n            (operators  ;  and  ,  must not appear together in a pattern)\n                                                                      1<2>3456Q'

_PAGE3 = '\nAGREP [-#cdehi[a|#]klnprstvwxyABDGIRS] [-f patternfile] [-H dir] pattern [files]\nagrep "colo#r" foo\n     show lines in file foo having strings "color" or "colour" or\n     "colonizer" or "coloniser" etc.\nagrep -2 -ci miscellaneous foo\n     count lines in file foo having string "miscellaneous", within 2 errors,\n     case insensitive\nagrep -niuV0By neeedle foo 2>nul\n     show line numbers in file foo having string "neeedle", within least errors,\n     case insensitive\nagrep "^From#\\.edu$" foo\n     show lines in file foo having string "From" at the beginning of a line\n     and string ".edu" at the end of the line\nagrep "abc[0-9](de|fg)*[x-z]" foo\n     show lines in file foo having string beginning "abc", followed by\n     one digit, then zero or more repetitions of "de" or "fg", and\n     finally x, y or z.\nagrep -d "^From " "search;retriev" mbox\n     show messages in file mbox having string "search" and string "retriev"\n     (Messages are delimited by the string "From " at the beginning of a line)\nagrep -1 -d "$$" "<bug> <report>" foo\n     show lines in file foo having string "bug report", or string "bug" at\n     end of a line and the string "report" at the beginning of the next line\nagrep -p "ACME" foo\n     find records in file foo that contain a supersequence of the pattern:\n     "ACME" will match "A Company that Manufactures Everything"\nagrep -i# "11zz11" foo\n     matches "74LS04" because of the digit-digit-letter(..) pattern   12<3>456Q'

_PAGE4 = '\nAGREP [-#cdehi[a|#]klnprstvwxyABDGIRS] [-f patternfile] [-H dir] pattern [files]\nAnd, how to search for double quotes " ?\n\n   To search for string" in all files *.c and to pipe the result\n   into a file x.x, use the following command:\n\n   >x.x AGREP "string\\\\\\"" *.c\n\n   Comment: The sequence \\\\\\" appears in AGREP as \\" (search for ").\n\nThe current default options as defined in the environment variable AGREPOPTS:\n\n   %(aopts)s\n\n   You could use "SET AGREPOPTS=<your options>" to change the default options.\n   The actual options in the command line take precedence.\n\n%(cpline)s\n\n   The codepage setting affects the uppercase-lowercase translation table\n   built-in AGREP when you use one of the options -i, -ia or -i# .\n   The translation table can be printed by using verbose option -V5.\n\nThe default verbose option is %(verbose)d                                       123<4>56Q'

_PAGE5 = '\nAGREP [-#cdehi[a|#]klnprstvwxyABDGIRS] [-f patternfile] [-H dir] pattern [files]\nAs of Sept 18, 2014, Webglimpse and Glimpse (AGREP is a part of it)\nare available under the ISC open source license, thanks to the\nUniversity of Arizona Office of Technology Transfer and all the developers,\nwho were more than happy to release it. http://opensource.org/licenses/ISC\n===============================================================================\nCopyright 1996, Arizona Board of Regents on behalf of The University of Arizona.\n\nPermission to use, copy, modify, and/or distribute this software for any\npurpose with or without fee is hereby granted, provided that the above\ncopyright notice and this permission notice appear in all copies.\n\nTHE SOFTWARE IS PROVIDED "AS IS" AND THE AUTHOR DISCLAIMS ALL WARRANTIES\nWITH REGARD TO THIS SOFTWARE INCLUDING ALL IMPLIED WARRANTIES OF\nMERCHANTABILITY AND FITNESS.\n\nIN NO EVENT SHALL THE AUTHOR BE LIABLE FOR ANY SPECIAL, DIRECT, INDIRECT,\nOR CONSEQUENTIAL DAMAGES OR ANY DAMAGES WHATSOEVER RESULTING FROM LOSS OF USE,\nDATA OR PROFITS, WHETHER IN AN ACTION OF CONTRACT, NEGLIGENCE OR OTHER\nTORTIOUS ACTION, ARISING OUT OF OR IN CONNECTION WITH THE USE OR PERFORMANCE\nOF THIS SOFTWARE.\n===============================================================================\n\n                                                                      1234<5>6Q'

_PAGE6 = '\nAGREP [-#cdehi[a|#]klnprstvwxyABDGIRS] [-f patternfile] [-H dir] pattern [files]\nAGREP is a powerful tool for searching a file or many files for a string or\nregular expression, with approximate matching capabilities and user-definable\nrecords. AGREP was developed 1989-1991 by Sun Wu and Udi Manber and many others\n(please read CONTRIB.TXT and MANUAL.DOC).\n\nAGREP is the search engine and part of the GLIMPSE tool for searching and\nindexing whole file systems. GLIMPSE stands for GLobal IMPlicit SEarch and is\npart of the HARVEST Information Discovery and Access System.\n\nAGREP as of %(date)s:\n===============================================\nThe home page for AGREP and GLIMPSE in general            http://webglimpse.net\nHome page AGREP                                      http://www.tgries.de/agrep\n\nThank you for using AGREP.\n                                                                      12345<6>Q'



def one_line_help(f=None) -> None:
    print(ONE_LINE, file=f or sys.stderr, end="")


def _page(n: int) -> str:
    if n == 4:
        aopts = os.environ.get("AGREPOPTS") or "(no default options)"
        # get_current_codepage() reads the DOS codepage -- absent on
        # POSIX builds, so the reference always prints the fallback
        cpline = ("The current codepage could not be detected. "
                  "AGREP will use CP850 by default.")
        return _PAGE4 % dict(aopts=aopts, cpline=cpline, verbose=1)
    if n == 6:
        # AGREP_DATE = __DATE__ (version.h:71, agrephlp.c:278): the
        # reference prints its compile date; we have no compile step,
        # so print today's in __DATE__ format ("Mmm dd yyyy", day
        # space-padded) -- documented divergence when the oracle's
        # build day differs
        t = time.localtime()
        date = "%s %2d %d" % (
            ("Jan Feb Mar Apr May Jun Jul Aug Sep Oct Nov "
             "Dec".split()[t.tm_mon - 1]), t.tm_mday, t.tm_year)
        return _PAGE6 % dict(date=date)
    return {1: _PAGE1, 2: _PAGE2, 3: _PAGE3, 5: _PAGE5}[n]


def online_help(f=None, stdin=None) -> None:
    """agrep_online_help (agrephlp.c:100-295): six pages with the
    userw navigation switch; getchar()-driven (one byte per page)."""
    f = f or sys.stderr
    stdin = stdin if stdin is not None else sys.stdin.buffer
    LAST = 7
    pg = 1
    while pg != LAST:
        if pg == 1:
            print(BANNER, file=f, end="")
        f.write(_page(pg))
        f.flush()
        try:
            ch = stdin.read(1)
        except Exception:
            ch = b""
        c = ch.decode("latin-1") if ch else ""
        if c and c in "123456":
            pg = int(c)
        elif c in ("Q", "q"):
            pg = LAST
        elif c == "-":
            if pg > 1:
                pg -= 1
        else:
            if pg < LAST:
                pg += 1


def print_version() -> None:
    print()
    print(BANNER)


def print_usage(out=None) -> None:
    """agrep_usage (agrep.c:3959): the full interactive help."""
    online_help(out or sys.stderr)
