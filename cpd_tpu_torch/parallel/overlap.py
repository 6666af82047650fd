"""Bucket layout of the gradient reduce (port of the layout part of
`cpd_tpu/parallel/overlap.py`; the overlapped taps are ROADMAP A6).

`bucket_layout` is the one capping function every bucketed reduce uses,
so bucket boundaries cannot drift between the ring and the faithful
gather."""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["DEFAULT_BUCKET_ELEMS", "bucket_layout"]

# Default per-bucket element cap: 4 Mi elements (16 MiB of fp32 per rank).
DEFAULT_BUCKET_ELEMS = 4 * 1024 * 1024


def bucket_layout(sizes: Sequence[int], bucket_elems: int,
                  group_ids: Optional[Sequence] = None) -> list:
    """Greedy bucket capping: split leaf indices into buckets of at most
    ``bucket_elems`` total elements (a single leaf larger than the cap
    forms its own bucket), preserving leaf order.  ``group_ids`` force a
    bucket break between unequal neighbours."""
    if bucket_elems < 1:
        raise ValueError(f"bucket_elems must be >= 1, got {bucket_elems}")
    buckets: list = []
    cur: list = []
    cur_n = 0
    cur_gid = None
    for i, n in enumerate(sizes):
        gid = None if group_ids is None else group_ids[i]
        if cur and (cur_n + n > bucket_elems or gid != cur_gid):
            buckets.append(cur)
            cur, cur_n = [], 0
        cur.append(i)
        cur_n += int(n)
        cur_gid = gid
    if cur:
        buckets.append(cur)
    return buckets
