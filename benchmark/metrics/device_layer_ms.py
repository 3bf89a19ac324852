"""device_layer_ms: the host's time inside the port's device-layer
functions that the configuration's "device_layer" lists (upload,
launches, synchronizing reads; the benchmark's own spans, a call inside
another counted once) a search, the mean over the traced window's
searches; moves search_gbs."""


def read(bundle):
    xs = [s.get("layer_s") for s in bundle["searches"]]
    if not xs or any(x is None for x in xs):
        return None
    return 1e3 * sum(xs) / len(xs)
