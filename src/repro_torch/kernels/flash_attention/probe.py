"""Inputs under which every key tile of a prefill row's range shows in the
row's output, and the outputs of the faults those inputs must expose.

With N(0, 1) q, K and V a row's output is an average of V rows over the keys
it attends, of magnitude about sqrt(e / n): below the check's absolute
tolerance (three bf16 roundings of 1) past about 5,000 keys. A kernel that
lost a key tile, or wrote zeros, would pass that check on most rows of a
long prompt. :func:`planted` keeps N(0, 1) inputs and plants, at every key
position that is a multiple of ``STRIDE``, a key that every query head of
the kv head scores far above the rest (about ``SCORE``). A planted key's V
row is 0 but for ``PLANT`` in one column, column (position / STRIDE) mod D.
Every key tile the kernels load is at least ``STRIDE`` keys wide, so a full
tile holds a planted key; a row's planted keys all score the same, so its
output is the mean of their V rows, and losing one moves its column by
PLANT / (keys planted in the row's range): 0.125 at 32,768 keys, several
times the tolerance. :func:`faults` gives the outputs of a lost first,
middle, last-before-diagonal and diagonal key tile of one block's rows, and
an output of zeros, from :func:`without` (the plain arithmetic over the
block's rows with the lost keys removed)."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels import softmax_scale
from repro_torch.kernels.flash_attention.flash_attention import (
    geometry, key_tiles, tile_key_range, tile_pairs)

STRIDE = 64      # a key planted at every multiple of this position
SCORE = 20.0     # a planted key's score (q * scale . k), about
PLANT = 64.0     # the one nonzero value of a planted key's V row


def planted(gen: torch.Generator, B: int, Sq: int, Sk: int, Hq: int,
            Hkv: int, D: int, device) -> Tuple[torch.Tensor, ...]:
    """bf16 q [B, Sq, Hq, D], K and V [B, Sk, Hkv, D], drawn from ``gen``,
    with a key planted at every multiple of ``STRIDE``. The G query heads
    of a kv head share a direction a (q = a + N(0, 1/4)); the planted key is
    ``SCORE * sqrt(D) * a / |a|^2``, so each head scores it about
    ``SCORE``."""
    G = Hq // Hkv

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    a = randn(B, 1, Hkv, 1, D)
    q = (a + 0.5 * randn(B, Sq, Hkv, G, D)).reshape(B, Sq, Hq, D).bfloat16()
    k = randn(B, Sk, Hkv, D).bfloat16()
    v = randn(B, Sk, Hkv, D).bfloat16()
    key = (SCORE * D ** 0.5 * a[:, 0, :, 0]
           / a[:, 0, :, 0].pow(2).sum(-1, keepdim=True)).bfloat16()
    pos = torch.arange(0, Sk, STRIDE, device=device)
    k[:, pos] = key[:, None]
    v[:, pos] = 0
    cols = (pos // STRIDE) % D
    v[:, pos, :, cols] = PLANT
    return q, k, v


def without(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, b: int,
            kh: int, rows: torch.Tensor, q_offset: int, window: int,
            causal: bool, kv_valid: Optional[torch.Tensor], lost: tuple,
            scale: Optional[float] = None) -> torch.Tensor:
    """[len(rows), G, D] bf16: query rows ``rows`` of sample ``b``, the G
    heads of kv head ``kh``, with the keys [lost[0], lost[1]) removed, in
    the plain version's arithmetic over one q block and one key block
    (``ref.flash_attention_ref``: q * scale in bf16, fp32 scores, the -1e30
    floor, p rounded to bf16 for P V, the block's P V rounded to bf16)."""
    Sk, Hkv, D = k.shape[1], k.shape[2], k.shape[3]
    G = q.shape[2] // Hkv
    qg = (q[b, rows, kh * G:(kh + 1) * G]
          * softmax_scale(scale, D, q.dtype)).float()
    s = torch.einsum("rgd,kd->rgk", qg, k[b, :, kh].float())
    pos = (q_offset + rows)[:, None]
    key = torch.arange(Sk, device=q.device)[None, :]
    w = window if window > 0 else 1 << 30
    keep = key > pos - w
    if causal:
        keep = keep & (key <= pos)
    if kv_valid is not None:
        keep = keep & (key < int(kv_valid[b]))
    keep = keep & ~((key >= lost[0]) & (key < lost[1]))
    s = torch.where(keep[:, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("rgk,kd->rgd", p.to(v.dtype).float(), v[b, :, kh].float())
    return (pv.to(v.dtype).float() / l.clamp_min(1e-30)).to(q.dtype)


def faults(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           want: torch.Tensor, *, causal: bool = True, window: int = 0,
           q_offset: Optional[int] = None,
           kv_valid: Optional[torch.Tensor] = None,
           instance: Optional[str] = None
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, output) of the faults a check on :func:`planted` inputs must
    catch: an output of zeros; and ``want`` with the rows of one block
    (sample 0, kv head 0: the last M tile whose diagonal key tile holds a
    planted key its rows attend, and that loads at least three tiles)
    recomputed with its first, a middle, its last-before-diagonal or its
    diagonal key tile lost, the tiles as the kernel's geometry
    (``instance``: the one it picks) cuts them."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    off = Sk - Sq if q_offset is None else q_offset
    kvv = Sk if kv_valid is None else int(kv_valid[0])
    geo = geometry(B, Sq, Sk, Hq, Hkv, D, causal, instance)
    yield "an output of zeros", torch.zeros_like(want)
    for tile in reversed(range(geo.m_tiles)):
        tiles = key_tiles(geo, tile, Sq, G, Sk, kvv, q_offset=off,
                          window=window, causal=causal)
        if len(tiles) < 3:
            continue
        last = tiles[-1][0]
        end = min(last + geo.k_tile, tile_key_range(
            tile, Sq, G, Sk, kvv, q_offset=off, window=window, causal=causal,
            m_tile=geo.m_tile)[1])
        if -(-last // STRIDE) * STRIDE < end:
            break
    else:
        return
    rows = sorted({r for r, _ in tile_pairs(tile, Sq, G, geo.m_tile)})
    rows_t = torch.tensor(rows, device=q.device)
    named = {"first": tiles[0][0], "middle": tiles[len(tiles) // 2][0],
             "last-before-diagonal": tiles[-2][0], "diagonal": last}
    for name, t0 in named.items():
        bad = want.clone()
        bad[0, rows_t, :G] = without(
            q, k, v, b=0, kh=0, rows=rows_t, q_offset=off, window=window,
            causal=causal, kv_valid=kv_valid, lost=(t0, t0 + geo.k_tile))
        yield (f"the {name} key tile ({t0}-{t0 + geo.k_tile}) of M tile "
               f"{tile}'s rows, sample 0, kv head 0 lost", bad)
