"""The committed smoke corpus (corpus/smoke/, built by
tools/build_smoke_corpus.py) and the tiler that grows it to batch size.

Readers need no image encoder: the files are plain JPEG bytes.  Tiling
repeats the distinct images in order, so every chunk of a tiled batch
holds the same mix and the device does the same work per chunk.
"""

from __future__ import annotations

import os

CORPUS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "corpus", "smoke",
)
N_DISTINCT = 16
KINDS = ("rst", "norst", "big", "dry_rst", "dry_norst", "dry_bucket",
         "dry_scale")


def load(kind: str) -> list[bytes]:
    """The distinct images of one kind, in name order: 'rst' and 'norst'
    give 16 640^2 images with and without restart markers, 'big' one
    2048^2 image; the tiny 'dry_*' kinds serve __graft_entry__'s sharded
    dry runs (tools/build_smoke_corpus.py lists them)."""
    if kind not in KINDS:
        raise ValueError(f"unknown corpus kind {kind!r}; expected one of {KINDS}")
    names = sorted(
        n for n in os.listdir(CORPUS_DIR)
        if n.startswith(kind + "_") and n.endswith(".jpg")
    )
    if not names:
        raise FileNotFoundError(f"no {kind!r} images in {CORPUS_DIR}")
    out = []
    for n in names:
        with open(os.path.join(CORPUS_DIR, n), "rb") as f:
            out.append(f.read())
    return out


def tile(datas: list[bytes], n: int) -> list[bytes]:
    """Repeat `datas` in order to exactly n entries (item i is datas[i % k])."""
    if not datas:
        raise ValueError("cannot tile an empty corpus")
    return [datas[i % len(datas)] for i in range(n)]
