"""A cell's inputs from its configuration, its traffic mix and a seed:
the corpus (written once to a file, from which every client cuts its
buffers) and each client's pool of buffers.  The reference gets the
same objects."""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import corpus


@dataclass
class Inputs:
    text: np.ndarray                # the corpus
    path: str                       # where text is written
    argv: list                      # the query's arguments
    pools: list                     # each client's buffer keys, in order
    spans: dict                     # buffer key -> (s, e) in text


def build(config: dict, traffic: dict, seed: int, workdir: str,
          scale: float = 1.0) -> Inputs:
    """The cell's inputs; scale shrinks every size (the harness's own
    tests run at a small one)."""
    n_bytes = int(traffic["corpus_bytes"] * scale)
    text = corpus.make_text(
        n_bytes, seed, plants=[w.encode() for w in traffic["plants"]],
        plant_every=traffic["plant_every"])
    path = os.path.join(workdir, "text.txt")
    text.tofile(path)
    size = max(int(traffic["buffer_bytes"] * scale), 4096)
    spans, pools = {}, []
    for c in range(traffic["clients"]):
        keys = []
        for s, e in corpus.buffer_spans(text, traffic["buffers_per_client"],
                                        size, seed, c):
            key = "b%d-%d" % (s, e)
            spans[key] = (s, e)
            keys.append(key)
        pools.append(keys)
    return Inputs(text, path, list(config["argv"]), pools, spans)
