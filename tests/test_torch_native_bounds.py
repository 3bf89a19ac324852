"""The native q-gram passes read no byte past their tables or their text.

qgram_first_per_line, qgram_first_per_anchor and qgram_occ_all
(agrep_tpu_torch/native/agrep_host.cpp) take a member table of 256 bytes
for a SHORT term set (p_size 1) and of 32,768 otherwise (2-gram and LONG
hashes), as compile/multi.py's build_qgram_tables makes them.  Here each pass runs in a subprocess of its own on copies of
the member table and of the text that end exactly at a page whose next
page is PROT_NONE (mmap, then mprotect through ctypes), so that a read
past either ends the subprocess with SIGSEGV: the test then fails with
the signal instead of taking the pytest worker down.  The rows it prints
must equal the same pass on ordinary numpy arrays, and qgram_occ_all's
must equal compile/multi.py's qgram_occurrences.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from agrep_tpu_torch import native as t_native
from agrep_tpu_torch.compile import multi as t_multi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs one pass on guarded copies: argv = inputs.npz, pass name, out.npz.
GUARDED = r"""
import ctypes, mmap, sys
import numpy as np
from agrep_tpu_torch import native

PAGE = mmap.PAGESIZE
libc = ctypes.CDLL(None, use_errno=True)
libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
keep = []


def at_page_end(a):
    # a copy of a whose last byte is the last of a page; the page after
    # it is PROT_NONE
    a = np.ascontiguousarray(a)
    pages = -(-a.nbytes // PAGE) + 1
    m = mmap.mmap(-1, pages * PAGE)
    base = ctypes.addressof(ctypes.c_char.from_buffer(m))
    if libc.mprotect(base + (pages - 1) * PAGE, PAGE, 0) != 0:
        raise OSError(ctypes.get_errno(), "mprotect")
    out = np.frombuffer(m, dtype=a.dtype, count=a.size,
                        offset=(pages - 1) * PAGE - a.nbytes)
    out[:] = a
    keep.append((m, out))
    return out


d = np.load(sys.argv[1])
lib = native.get_lib()
text = at_page_end(d["text"])
member = at_page_end(d["member"].astype(np.uint8))
fixed = (text, len(text), member, d["hash_id"], d["b_off"], d["b_tids"],
         d["t_bytes"], d["t_off"], d["tr"], int(d["p"]), int(d["longf"]),
         int(d["shortf"]))
out_a = np.zeros(1 << 18, dtype=np.int64)
out_t = np.zeros(1 << 18, dtype=np.int64)
if sys.argv[2] == "qgram_first_per_line":
    cnt = lib.qgram_first_per_line(*fixed, 0, out_a, out_t, len(out_a))
elif sys.argv[2] == "qgram_first_per_anchor":
    cnt = lib.qgram_first_per_anchor(
        *fixed, 0, np.frombuffer(b"\n", np.uint8).copy(), 0,
        np.zeros(0, dtype=np.int64), 0, 0, out_a, out_t, len(out_a))
else:
    cnt = lib.qgram_occ_all(*fixed, out_a, out_t, len(out_a))
assert cnt <= len(out_a), cnt
np.savez(sys.argv[3], a=out_a[:cnt], t=out_t[:cnt])
"""

PASSES = ("qgram_first_per_line", "qgram_first_per_anchor", "qgram_occ_all")

# (id, terms): SHORT (a one-byte term: member u8[256]), 2-gram and LONG
# (more than 400 term bytes, p_size 3)
SETS = [
    ("short", [b"x", b"alpha", b"gam", b"de b", b"kernel"]),
    ("two_gram", [b"alpha", b"gam", b"de b", b"kernel", b"xa"]),
    ("long", [b"w%03d%s" % (i, b"lmnop"[: i % 5]) for i in range(90)]
     + [b"alpha", b"gamma"]),
]


def _inputs(terms, seed):
    rnd = random.Random(seed)
    pieces = [b"alpha", b"beta", b"gam", b"de", b"x", b"kernel", b"w017lm",
              b" ", b"\n", b"a1", b"Alpha", b"w042lmn"]
    text = np.frombuffer(b"".join(rnd.choices(pieces, k=3000)),
                         dtype=np.uint8).copy()
    tr = np.arange(256, dtype=np.uint8)
    tb = t_multi.build_qgram_tables(terms, tr)
    b_off, b_tids, t_bytes, t_off = t_multi.csr_tables(tb, terms)
    return tb, dict(text=text, member=tb.member, hash_id=tb.hash_id,
                    b_off=b_off, b_tids=b_tids, t_bytes=t_bytes,
                    t_off=t_off, tr=tr, p=tb.p_size, longf=int(tb.long_),
                    shortf=int(tb.short))


def _in_process(name, d):
    """The pass through its numpy wrapper, on ordinary arrays."""
    args = (d["text"], d["member"], d["hash_id"], d["b_off"], d["b_tids"],
            d["t_bytes"], d["t_off"], d["tr"], d["p"], bool(d["longf"]),
            bool(d["shortf"]))
    if name == "qgram_occ_all":
        return t_native.qgram_occ_all(*args)
    return getattr(t_native, name)(*args, False)


@pytest.mark.parametrize("which", PASSES)
@pytest.mark.parametrize("kind,terms", SETS, ids=[s[0] for s in SETS])
def test_pass_reads_inside_its_tables_and_text(which, kind, terms,
                                               tmp_path):
    assert t_native.get_lib() is not None
    tb, d = _inputs(terms, 7)
    assert (tb.short, bool(tb.long_)) == {
        "short": (True, False), "two_gram": (False, False),
        "long": (False, True)}[kind]
    assert len(tb.member) == (256 if tb.short else 32768)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **d)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", GUARDED, str(src), which,
                           str(dst)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, (
        "%s ended with %s on guarded tables (a negative code is the signal "
        "that ended it):\n%s" % (which, proc.returncode, proc.stderr[-2000:]))
    got = np.load(dst)
    want_a, want_t = _in_process(which, d)
    assert np.array_equal(got["a"], want_a)
    assert np.array_equal(got["t"], want_t)
    assert len(want_a) > 0
    if which == "qgram_occ_all":
        occ = t_multi.qgram_occurrences(d["text"], terms, d["tr"], tb)
        pairs = sorted((int(s) + tb.p_size - 1, tid)
                       for tid, starts in occ.items() for s in starts)
        assert sorted(zip(got["a"].tolist(), got["t"].tolist())) == pairs
