"""kernel_ms: device time of every kernel (torch.profiler's kernel
events) in the traced window, every client's, over the window's
completed searches; moves search_gbs."""


def read(bundle):
    n = len(bundle["searches"])
    lo, hi = bundle["window"]
    t = sum(min(e, hi) - max(s, lo) for s, e, kind, _n, _c
            in bundle["device"] if kind == "kernel")
    if not n or t <= 0:
        return None
    return 1e3 * t / n
