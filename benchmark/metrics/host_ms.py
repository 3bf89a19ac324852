"""host_ms: a search's wall less its compile stage and its device-layer
spans (the engines, the record walk, the print, the file read), the
mean over the traced window's searches; moves search_gbs."""


def read(bundle):
    xs = []
    for s in bundle["searches"]:
        if s.get("layer_s") is None:
            return None
        xs.append(s["t1"] - s["t0"] - (s.get("compile_s") or 0.0)
                  - s["layer_s"])
    if not xs:
        return None
    return 1e3 * sum(xs) / len(xs)
