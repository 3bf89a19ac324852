"""h2d_ms: device time of the host-to-device copies (torch.profiler's
Memcpy HtoD events) in the traced window, every client's, over the
window's completed searches; moves search_gbs."""


def read(bundle):
    n = len(bundle["searches"])
    lo, hi = bundle["window"]
    if not n or not bundle["device"]:
        return None
    t = sum(min(e, hi) - max(s, lo) for s, e, kind, _n, _c
            in bundle["device"] if kind == "h2d")
    return 1e3 * t / n
