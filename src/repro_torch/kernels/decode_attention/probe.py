"""Inputs under which every block's share of a decode-attention call shows in
its output, and the outputs of the faults those inputs must expose.

With N(0, 1) q, K and V the output is an average of V rows over the
sample's positions, of magnitude about sqrt(e / n): a few thousandths at
524,288 positions, below the check's absolute tolerance (three bf16
roundings of 1). A kernel that lost a block's partial, a tile of a slice or
the whole sum would pass that check there. :func:`planted` keeps N(0, 1)
inputs and plants, at the first and the last position of each of the ``p``
slices the kernel cuts a sample's valid range into (``decode_attention.
split_slices``), a key that every query head of the kv head scores far
above the rest (about ``SCORE`` against N(0, 1.25)). A planted key's V row
is 0 but for ``PLANT`` in one column, taken in turn (column i mod D for the
sample's i-th planted key). The planted keys of a (kv head, sample) all
score the same, so the output is the mean of their V rows: at least
PLANT / 128 in every column they feed, where at most 2 * MAX_SPLITS keys
are planted, and losing one of them moves its column by PLANT / (keys
planted), at least 0.125, several times the tolerance. So a lost slice, a
lost first or last tile of a slice, or an output of zeros fails the check.
:func:`faults` gives those outputs, from the plain version over the cache
with the lost positions removed (:func:`without`)."""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from repro_torch.kernels import softmax_scale
from repro_torch.kernels.decode_attention.decode_attention import (
    TILE_KEYS, split_slices)

SCORE = 20.0     # a planted key's score (q * scale . k), about
PLANT = 64.0     # the one nonzero value of a planted key's V row


def _slices(lengths: Sequence[int], Smax: int, window: int,
            p: int) -> List[List[Tuple[int, int]]]:
    """Each sample's nonempty slices, as the kernel cuts them."""
    return [[(s0, s1) for s0, s1 in split_slices(int(n), Smax, window, p)
             if s1 > s0] for n in lengths]


def planted(gen: torch.Generator, B: int, Hq: int, Hkv: int, D: int,
            Smax: int, window: int, lengths: Sequence[int], p: int,
            device) -> Tuple[torch.Tensor, ...]:
    """bf16 q [B, 1, Hq, D], K and V [B, Smax, Hkv, D] and int32 lengths,
    drawn from ``gen``, with a key planted at the first and the last
    position of each nonempty slice of the ``p`` a sample's range is split
    into. The G query heads of a kv head share a direction a (q = a +
    N(0, 1/4)); the planted key is ``SCORE * sqrt(D) * a / |a|^2``, so
    each head scores it about ``SCORE``."""
    G = Hq // Hkv

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    a = randn(B, Hkv, D)
    q = (a[:, :, None] + 0.5 * randn(B, Hkv, G, D)).reshape(
        B, 1, Hq, D).bfloat16()
    k = randn(B, Smax, Hkv, D).bfloat16()
    v = randn(B, Smax, Hkv, D).bfloat16()
    key = (SCORE * D ** 0.5 * a / a.pow(2).sum(-1, keepdim=True)).bfloat16()
    bs, pos, cols = [], [], []
    for b, row in enumerate(_slices(lengths, Smax, window, p)):
        ends = sorted({e for s0, s1 in row for e in (s0, s1 - 1)})
        bs += [b] * len(ends)
        pos += ends
        cols += [i % D for i in range(len(ends))]
    if bs:
        bi = torch.tensor(bs, device=device)
        pi = torch.tensor(pos, device=device)
        k[bi, pi] = key[bi]
        v[bi, pi] = 0
        v[bi, pi, :, torch.tensor(cols, device=device)] = PLANT
    ln = torch.tensor(list(lengths), dtype=torch.int32, device=device)
    return q, k, v, ln


def without(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            lengths: torch.Tensor, window: int,
            drop: torch.Tensor) -> torch.Tensor:
    """The plain version (``ref.decode_attention_ref``, step for step) over
    the valid positions less ``drop`` ([B, Hkv, Smax] bool): what a kernel
    that lost those positions returns."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = (q.reshape(B, Hkv, Hq // Hkv, D)
          * softmax_scale(None, D, q.dtype)).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    pos = torch.arange(Smax, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    lo = lens - window if window > 0 else torch.zeros_like(lens)
    keep = ((pos < lens) & (pos >= lo))[:, None, :] & ~drop  # [B, Hkv, Smax]
    s = torch.where(keep[:, :, None, :], s, torch.full_like(s, -1e30))
    pr = torch.softmax(s, dim=-1)
    pr = torch.where(keep.any(-1)[:, :, None, None], pr,
                     torch.zeros_like(pr))
    o = torch.einsum("bhgk,bkhd->bhgd", pr.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.to(v_cache.dtype).reshape(B, 1, Hq, D)


def faults(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           lengths: torch.Tensor, window: int,
           p: int) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, output) of the faults a check on :func:`planted` inputs split
    ``p`` ways must catch (none where no sample has a valid position): an
    output of zeros; on the sample with the most valid positions, kv head
    0, its first, a middle and its last slice lost (a partial dropped from
    the merge), and its first slice's first tile and last tile lost; the
    last tile of every slice lost."""
    B, Smax, Hkv = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    full = _slices(lengths.tolist(), Smax, window, p)
    if not any(full):
        return
    yield "an output of zeros", torch.zeros_like(q)
    b = max(range(B), key=lambda i: sum(s1 - s0 for s0, s1 in full[i]))

    def lose(ranges):
        """The output with positions [s0, s1) of (sample, kv head, or every
        head where None) removed, for each (sample, head, s0, s1)."""
        drop = torch.zeros((B, Hkv, Smax), dtype=torch.bool,
                           device=q.device)
        for bi, h, s0, s1 in ranges:
            drop[bi, slice(None) if h is None else h, s0:s1] = True
        return without(q, k_cache, v_cache, lengths, window, drop)

    def last_tile(s0, s1):
        return s0 + (s1 - s0 - 1) // TILE_KEYS * TILE_KEYS, s1

    row = full[b]
    for j in sorted({0, len(row) // 2, len(row) - 1}):
        yield (f"slice {j} of sample {b}, kv head 0 lost",
               lose([(b, 0, *row[j])]))
    s0, s1 = row[0]
    yield (f"the first tile of sample {b}'s first slice, kv head 0 lost",
           lose([(b, 0, s0, min(s1, s0 + TILE_KEYS))]))
    yield (f"the last tile of sample {b}'s first slice, kv head 0 lost",
           lose([(b, 0, *last_tile(s0, s1))]))
    yield "the last tile of every slice lost", lose(
        [(bi, None, *last_tile(s0, s1))
         for bi in range(B) for s0, s1 in full[bi]])
