"""Fletcher-style payload digests, the ring's tag algebra and the
replica consensus pair (port of `cpd_tpu/parallel/integrity.py`).

``digest = (s2 << 16) | s1`` with ``s1 = Σ w_i`` and
``s2 = Σ ((i mod 65521) + 1) · w_i``, both mod 65521 (`DIGEST_MOD`),
over the payload's words in flatten order: the bytes of a packed page,
the bit patterns of a float payload.  Bitwise the JAX digest; the JAX
module reduces in chunked uint32 sums to stay overflow-free, this one
sums in int64, where no partial sum of a realistic payload can
overflow (each term is below 2^32, so 2^31 terms fit).

Digests, tags and tree digests are int64 tensors holding the JAX
package's uint32 values.  The tag products and the FNV fold are masked
to 32 bits after every multiply and xor, as uint32 arithmetic wraps.
"""

from __future__ import annotations

import torch

__all__ = ["wire_digest", "row_digests", "tree_digest", "tag_from_digest",
           "hop_tag", "digest_concat", "digest_agree", "tensor_leaves",
           "make_consensus_fns", "DIGEST_MOD"]

DIGEST_MOD = 65521
_U32 = 0xFFFFFFFF
# the odd multipliers that mix the hop index and the sender rank into a tag
_GOLD_HOP = 0x9E3779B9
_GOLD_SRC = 0x85EBCA6B


def _mod65521(x: torch.Tensor) -> torch.Tensor:
    """x % 65521 for non-negative int64 x."""
    return torch.remainder(x, DIGEST_MOD)


def _mod_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of the last axis mod DIGEST_MOD."""
    return _mod65521(v.sum(dim=-1))


def _digest_words(flat: torch.Tensor) -> torch.Tensor:
    """int64 hash words in [0, 2^32) of a payload: always the BIT
    PATTERN (floats bitcast to the same-width unsigned), integers
    zero-extended from their own width."""
    dt = flat.dtype
    if dt.is_floating_point:
        if dt.itemsize == 4:
            return flat.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        if dt.itemsize == 2:
            return flat.view(torch.int16).to(torch.int64) & 0xFFFF
        return (flat.to(torch.float32).view(torch.int32).to(torch.int64)
                & 0xFFFFFFFF)
    if dt == torch.uint8 or dt == torch.bool:
        return flat.to(torch.int64)
    if dt.itemsize <= 4:
        return flat.to(torch.int64) & ((1 << (8 * dt.itemsize)) - 1)
    raise TypeError(f"no digest words for {dt}")


def row_digests(rows: torch.Tensor) -> torch.Tensor:
    """One digest per leading index: ``rows`` (N, ...) -> (N,) int64,
    each the `wire_digest` of ``rows[i]`` — the batched form the KV
    cache uses for its per-page digests."""
    w = _mod65521(_digest_words(rows.reshape(rows.shape[0], -1)))
    pos = _mod65521(torch.arange(w.shape[1], dtype=torch.int64,
                                 device=w.device)) + 1
    s1 = _mod_sum(w)
    s2 = _mod_sum(w * pos)
    return (s2 << 16) | s1


def wire_digest(x: torch.Tensor) -> torch.Tensor:
    """Fletcher-style digest of any payload tensor: an int64 scalar
    holding the JAX function's uint32 value."""
    return row_digests(x.reshape(1, -1))[0]


def tree_digest(leaves) -> torch.Tensor:
    """One digest over a list of tensors: the FNV-style fold
    ``d = (d * 0x01000193) ^ wire_digest(leaf)`` from ``0x811C9DC5``, in
    list order (the JAX function folds in tree-flatten order)."""
    d = None
    for leaf in leaves:
        w = wire_digest(leaf)
        d = ((0x811C9DC5 if d is None else d) * 0x01000193 & _U32) ^ w
    if d is None:
        return torch.tensor(0x811C9DC5, dtype=torch.int64)
    return d


def tag_from_digest(digest, hop, src_rank):
    """A payload digest mixed with its (hop, sender) provenance:
    ``digest ^ (hop * GOLD_HOP) ^ (src * GOLD_SRC)`` in uint32."""
    return (digest ^ ((hop & _U32) * _GOLD_HOP & _U32)
            ^ ((src_rank & _U32) * _GOLD_SRC & _U32))


def hop_tag(payload: torch.Tensor, hop, src_rank):
    """The per-hop wire checksum: `tag_from_digest` of the payload's
    `wire_digest`."""
    return tag_from_digest(wire_digest(payload), hop, src_rank)


def digest_concat(d_a, len_a: int, d_b):
    """The digest of the concatenation of two payloads from theirs:
    ``s1 = s1a + s1b``, ``s2 = s2a + s2b + len_a * s1b`` (mod 65521;
    the second payload's position weights shift by ``len_a``)."""
    s1a, s2a = d_a & 0xFFFF, d_a >> 16
    s1b, s2b = d_b & 0xFFFF, d_b >> 16
    s1 = (s1a + s1b) % DIGEST_MOD
    s2 = (s2a + s2b + (len_a % DIGEST_MOD) * s1b % DIGEST_MOD) % DIGEST_MOD
    return (s2 << 16) | s1


def digest_agree(digests, mesh) -> list:
    """int32 1/0 for each local rank of ``mesh``: do all ranks hold the
    same digest (the JAX function's pmin == pmax)?  ``digests`` holds
    one int64 digest per local rank."""
    lo = mesh.min(digests)
    hi = mesh.max(digests)
    return [(a == b).to(torch.int32) for a, b in zip(lo, hi)]


def tensor_leaves(tree) -> list:
    """The tensors of ``tree`` in a fixed order: a module's parameters
    then its buffers; a `train.state.TrainState`'s module, then its
    optimizer state; the fields of a tuple (a NamedTuple optimizer
    state) or list, and a dict's values, in order.  Ints, keys and None
    hold no tensor."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if hasattr(tree, "model") and hasattr(tree, "opt_state"):
        return tensor_leaves(tree.model) + tensor_leaves(tree.opt_state)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


def make_consensus_fns(mesh) -> tuple:
    """``(check_fn, resync_fn)`` over a replicated tree (a `TrainState`,
    a module, tensors; `tensor_leaves`).

    ``check_fn(tree)``: int32 1/0, do all ranks hold the same
    `tree_digest` of their copy (`digest_agree`)?  ``resync_fn(tree)``:
    rank 0's bytes on every rank, copied in place from
    `parallel.dist.broadcast_from` of each tensor, returning ``tree``.  A
    `LocalMesh` keeps one copy for all its ranks, so it always agrees
    and the resync is the identity."""

    def check_fn(tree) -> torch.Tensor:
        d = tree_digest(tensor_leaves(tree))
        return digest_agree([d] * len(mesh.ranks), mesh)[0]

    def resync_fn(tree):
        from .dist import broadcast_from

        with torch.no_grad():
            for t in tensor_leaves(tree):
                t.copy_(broadcast_from(t, mesh, 0))
        return tree

    return check_fn, resync_fn
