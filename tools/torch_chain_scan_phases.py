#!/usr/bin/env python3
"""Where the chain kernel's time goes, on one CUDA GPU.

    python3 tools/torch_chain_scan_phases.py [--seed N] [--mb 100] [--reps 20]

Builds csrc/chain_scan.cu four ways into build/kernels/phases/: as it
is; without the bucket tests (every candidate of the bitmap counts as a
start); compute alone (each block stages and translates its first tile
only, then computes every later tile on it); and staging and translation
alone (no probes, no bucket tests, no stores).  Times each with CUDA
events (one warm-up launch, then --reps launches) at config 5's 100
patterns and bool5's two terms over chip_smoke's 100 MB records stream,
with the wrapper's own tile and blocks an SM, beside chip_smoke's
chain_bound().  Only the first build writes a plane; it is held bit for
bit against chain_scan_reference.  Beside the times it counts on the
host, over the first 8 MB of each text, the share of positions that pass
a class-pair filter and the kernel's candidate bitmap, the share of
rounds of 32 consecutive positions with a pair candidate, and the
shared-memory accesses a warp's bitmap probe needs (distinct words in
its busiest bank), with the bitmap's XOR swizzle and without it.  The
variants are cut from the source by its text, so a change to the kernel
that moves a cut makes this tool fail, not mislead.  The first line is the card's name and power limit.
Exits non-zero without a CUDA device, on a failed build or on a
mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError("chain_scan.cu no longer holds %r once" % old)
    return src.replace(old, new)


def variants(src: str) -> dict:
    """{name: source} of the four builds."""
    compute = _cut(src, "const uint8_t* raw = smem + (k & 1) * l.raw;",
                   "const uint8_t* raw = smem;")
    compute = _cut(compute, "        if (t + gridDim.x < n_tiles)\n",
                   "        if (false)\n")
    compute = _cut(compute, "for (int w = tid; w < n_cw; w += kThreads)",
                   "for (int w = tid; k == 0 && w < n_cw; w += kThreads)")
    start = "        const uint8_t* cls = reinterpret_cast<const uint8_t*>"
    end = "    cp_async_wait<0>();\n}"
    i, j = src.index(start), src.index(end)
    return {
        "kernel": src,
        "no bucket tests": _cut(src, "            while (cand) {",
                                "            hits = cand;\n"
                                "            while (false) {"),
        "compute alone": compute,
        "staging and translation": src[:i] + "    }\n" + src[j:],
    }


def filter_counts(text, p) -> str:
    """The host counts of the module docstring, for program p over the
    u8 numpy array text."""
    import numpy as np
    C = p.n_cls
    stride = C + 1
    cm = p.class_of.cpu().numpy().astype(np.int64)
    cm[cm == 255] = C
    single = p.single.cpu().numpy().astype(bool)
    pair = p.pair.cpu().numpy().astype(np.int64)
    term = p.term_cls.cpu().numpy().astype(np.int64)
    off = p.term_off.cpu().numpy().astype(np.int64)
    n = len(text) // 1024 * 1024
    cls = np.concatenate([cm[text[:n + 2]], [cm[0]] * 2])
    c0, c1, c2 = cls[:n], cls[1:n + 1], cls[2:n + 2]
    lead = np.concatenate([single, [False]])[c0]
    pair_ok = (pair[c0 * stride + c1 + 1] != pair[c0 * stride + c1]) | lead
    cand = pair_ok
    if C < 32:
        tri = np.zeros((stride, stride, stride), dtype=bool)
        for t in range(int(pair[-1])):
            a = term[off[t]:off[t + 1]]
            tri[a[0], a[1], a[2] if len(a) > 2 else slice(None)] = True
        cand = tri[c0, c1, c2] | lead
    rounds = pair_ok.reshape(-1, 32).any(axis=1).mean()

    def accesses(word):
        # lane l probes position 32 l + r of each 1024-position group
        w = np.sort(word.reshape(-1, 32, 32).transpose(0, 2, 1)
                    .reshape(-1, 32), axis=1)
        first = np.ones(w.shape, dtype=bool)
        first[:, 1:] = w[:, 1:] != w[:, :-1]
        busy = np.zeros((len(w), 32), dtype=np.int64)
        rows = np.broadcast_to(np.arange(len(w))[:, None], w.shape)
        np.add.at(busy, (rows[first], w[first] % 32), 1)
        return busy.max(axis=1).mean()
    if C < 32:
        probe = "%.2f (%.2f without the XOR)" % (
            accesses(32 * c0 + (c0 ^ c1)), accesses(32 * c0 + c1))
    else:
        probe = "%.2f" % accesses(4 * c0 + (c1 >> 5))
    return ("pair filter %.3f %% of positions, candidate bitmap %.3f %%, "
            "rounds of 32 with a pair candidate %.1f %%, shared accesses "
            "a probe %s" % (100 * pair_ok.mean(), 100 * cand.mean(),
                            100 * rounds, probe))


def build(srcs: dict) -> dict:
    """{name: loaded library}, all nvcc processes started together."""
    from agrep_tpu_torch.ops import _cuda
    out_dir = os.path.join(_cuda.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k, (name, src) in enumerate(srcs.items()):
        cu = os.path.join(out_dir, "chain_scan_%d.cu" % k)
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, "libchain_scan_%d.so" % k)
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (name, log))
        lib = ctypes.CDLL(so)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.chain_scan_launch.restype = i
        lib.chain_scan_launch.argtypes = [p, ll, p, p, i, p, i, p, i, p, i,
                                          p, i, i, p]
        lib.chain_scan_geometry.restype = i
        lib.chain_scan_geometry.argtypes = [i, i, i, i, i, ip, ip, ip]
        lib.chain_scan_error_string.restype = ctypes.c_char_p
        lib.chain_scan_error_string.argtypes = [i]
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_chain_scan_phases: no CUDA device", file=sys.stderr)
        return 1
    from agrep_tpu_torch.ops import _cuda, chain_kernel, timing
    from tools.torch_chain_scan_time import shapes
    print(timing.card_line())
    with open(os.path.join(REPO, "agrep_tpu_torch", "csrc",
                           "chain_scan.cu")) as f:
        libs = build(variants(f.read()))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []
    for name, text, p in shapes(args.mb, args.seed, "cuda"):
        if name not in ("config5", "bool5"):
            continue
        N = text.numel()
        want = chain_kernel.chain_scan_reference(text, p)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream
        row = []
        for vname, lib in libs.items():
            threads, smem, fits = (ctypes.c_int(), ctypes.c_int(),
                                   ctypes.c_int())
            _cuda.check(lib, "chain_scan", lib.chain_scan_geometry(
                p.n_cls, p.n_pos, p.n_terms, p.maxlen, chain_kernel.TILE,
                ctypes.byref(threads), ctypes.byref(smem),
                ctypes.byref(fits)), "geometry")

            def launch(lib=lib, grid=n_sm * fits.value):
                _cuda.check(lib, "chain_scan", lib.chain_scan_launch(
                    text.data_ptr(), N, p.class_of.data_ptr(),
                    p.single.data_ptr(), p.n_cls, p.term_cls.data_ptr(),
                    p.n_pos, p.term_off.data_ptr(), p.n_terms,
                    p.pair.data_ptr(), p.maxlen, out.data_ptr(),
                    chain_kernel.TILE, grid, stream), "kernel launch")
            launch()
            torch.cuda.synchronize()
            if vname == "kernel" and not torch.equal(out, want):
                failed.append(name)
            row.append("%s %.4f ms" % (vname, timing.time_kernel(
                launch, args.reps)))
        bms, by = timing.chain_bound(N)
        print("phases: %-7s N=%d tile=%d | %s | bound %.4f ms (%s)"
              % (name, N, chain_kernel.TILE, " | ".join(row), bms, by))
        print("counts: %-7s %s (host, first 8 MB)" % (
            name, filter_counts(text[:8 << 20].cpu().numpy(), p)))
    print("card: %s" % timing.card_line())
    if failed:
        print("mismatches: %s" % failed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
