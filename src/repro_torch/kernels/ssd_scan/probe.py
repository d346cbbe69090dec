"""Inputs under which every chunk of a long scan shows in its outputs, the
chunked kernel's decomposition in plain torch, and the outputs of the faults
those inputs must expose.

Under hymba's own gates (``dt = softplus(N(0, 1))``, so log_f is about -0.7
a step) the state a chunk carries in is multiplied by about e^-0.7 at every
position: after some 30 positions nothing of it is left, and a final state
that left out an early chunk differs by about e^-180. A kernel that carried
the wrong state into a chunk, or lost a chunk's local state, would pass the
check. :func:`planted` draws slow gates instead (``dt`` in [DT / 2, 3 DT / 2],
log_f = -dt, log_i = log dt, as trained SSMs keep them so that the state
lasts), q and k of one (b, h) sharing a direction (so a chunk's keys add up
instead of cancelling), and v with ``PLANT`` added in column c mod dv at
every position of chunk c: each chunk then owns a column of the final state
and of every later chunk's y, several times the check's tolerance.

:func:`decomposed` computes the scan as the chunked instance cuts it (each
chunk's local state, the scan over chunks, each chunk's y from the state
before it) with the plain version's rounding points; :func:`faults` gives
its outputs with one (b, h)'s chunk local state lost, the carry into the
last chunk taken from two chunks back or without its exp(tot), one 16-row
group's state read lost, and an output of zeros."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.ref import check_chunk

DT = 1e-3       # the planted gates' mean step
PLANT = 8.0     # added to v's column c mod dv over chunk c
GROUP = 16      # chunk rows a warp of the chunked instance's y block takes


def planted(gen: torch.Generator, B: int, S: int, H: int, dk: int, dv: int,
            chunk: int, device) -> Tuple[torch.Tensor, ...]:
    """bf16 q, k [B, S, H, dk] and v [B, S, H, dv], fp32 log_f, log_i
    [B, S, H], drawn from ``gen`` (on ``device``): q = a + N(0, 1/4) and
    k = a + N(0, 1/4) with a ~ N(0, 1) a (b, h); v ~ N(0, 1) plus ``PLANT``
    in column c mod dv over chunk c; dt uniform in [DT / 2, 3 DT / 2]."""
    W = check_chunk(S, chunk)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    a = randn(B, 1, H, dk)
    q = (a + 0.5 * randn(B, S, H, dk)).bfloat16()
    k = (a + 0.5 * randn(B, S, H, dk)).bfloat16()
    v = randn(B, S, H, dv)
    pos = torch.arange(S, device=device)
    v[:, pos, :, (pos // W) % dv] += PLANT
    dt = DT * (0.5 + torch.rand((B, S, H), generator=gen, device=device))
    return q, k, v.bfloat16(), -dt, torch.log(dt)


def local_states(k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                 log_i: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's local state L_c = k_scaled^T v [B, H, nc, dk, dv] and
    its tot [B, H, nc] (fp32), k_scaled = fp32(k * exp(tot - cum +
    log_i))."""
    B, S, H, dk = k.shape
    dv = v.shape[-1]
    W = check_chunk(S, chunk)
    nc = S // W
    cum = torch.cumsum(log_f.reshape(B, nc, W, H).float(), dim=2)
    tot = cum[:, :, -1:]
    ks = (k.reshape(B, nc, W, H, dk).float()
          * torch.exp(tot - cum + log_i.reshape(B, nc, W, H).float())[..., None])
    L = torch.einsum("bcwhk,bcwhv->bhckv", ks,
                     v.reshape(B, nc, W, H, dv).float())
    return L, tot[:, :, 0].permute(0, 2, 1)


def carries(L: torch.Tensor, tot: torch.Tensor,
            initial_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan over chunks: (the state before each chunk [B, H, nc, dk,
    dv], the final state), S <- S * exp(tot_c) + L_c from the initial state
    or zeros."""
    B, H, nc, dk, dv = L.shape
    S = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=L.device)
         if initial_state is None else initial_state.float())
    before = []
    for c in range(nc):
        before.append(S)
        S = S * torch.exp(tot[:, :, c])[..., None, None] + L[:, :, c]
    return torch.stack(before, dim=2), S


def outputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_f: torch.Tensor, log_i: torch.Tensor, before: torch.Tensor,
            chunk: int) -> torch.Tensor:
    """y [B, S, H, dv] in v's dtype: each chunk's state read from the state
    before it, ``exp(cum) * (q . S)``, plus its decay-masked intra-chunk
    scores times v, rounded once."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    W = check_chunk(S, chunk)
    nc = S // W
    qc = q.reshape(B, nc, W, H, dk).float()
    kc = k.reshape(B, nc, W, H, dk).float()
    vc = v.reshape(B, nc, W, H, dv).float()
    cum = torch.cumsum(log_f.reshape(B, nc, W, H).float(), dim=2)
    li = log_i.reshape(B, nc, W, H).float()
    y_state = (torch.einsum("bcwhk,bhckv->bcwhv", qc, before)
               * torch.exp(cum)[..., None])
    scores = torch.einsum("bcwhk,bcuhk->bchwu", qc, kc)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :] + li[:, :, None]
    causal = torch.ones((W, W), dtype=torch.bool, device=q.device).tril()
    decay = torch.where(causal[None, None, :, :, None], decay,
                        torch.full_like(decay, float("-inf")))
    scores = scores * torch.exp(decay).permute(0, 1, 4, 2, 3)
    y_intra = torch.einsum("bchwu,bcuhv->bcwhv", scores, vc)
    return (y_state + y_intra).to(v.dtype).reshape(B, S, H, dv)


def decomposed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_f: torch.Tensor, log_i: torch.Tensor, *, chunk: int,
               initial_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) through :func:`local_states`, :func:`carries` and
    :func:`outputs`: the plain version's function, cut as the chunked
    instance cuts it."""
    L, tot = local_states(k, v, log_f, log_i, chunk)
    before, final = carries(L, tot, initial_state)
    return outputs(q, k, v, log_f, log_i, before, chunk), final


def faults(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           log_f: torch.Tensor, log_i: torch.Tensor, *, chunk: int,
           initial_state: Optional[torch.Tensor] = None
           ) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor]]:
    """(name, y, final state) of the faults a check on :func:`planted`
    inputs must catch, each in one block's reach (sample 0, head 0): an
    output of zeros; chunk 0's or the last chunk's local state lost; the
    carry into the last chunk taken from two chunks back (the state before
    the chunk before it) or without its exp(tot); the state read of the
    last chunk's last 16-row group (one warp's share of the chunked
    instance's y block) lost."""
    B, S, H, dk = q.shape
    W = check_chunk(S, chunk)
    nc = S // W
    L, tot = local_states(k, v, log_f, log_i, chunk)
    before, final = carries(L, tot, initial_state)
    yield ("an output of zeros", torch.zeros_like(v),
           torch.zeros_like(final))

    def rerun(L2, before2=None, final2=None):
        b2, f2 = carries(L2, tot, initial_state)
        b2 = b2 if before2 is None else before2
        f2 = f2 if final2 is None else final2
        return outputs(q, k, v, log_f, log_i, b2, chunk), f2

    for c in sorted({0, nc - 1}):
        L2 = L.clone()
        L2[0, 0, c] = 0
        yield (f"chunk {c}'s local state lost (sample 0, head 0)",
               *rerun(L2))
    if nc >= 2:
        last = nc - 1
        for name, carry in (
                ("taken from two chunks back", before[0, 0, last - 1]),
                ("without its exp(tot)",
                 before[0, 0, last - 1] + L[0, 0, last - 1])):
            b2 = before.clone()
            b2[0, 0, last] = carry
            f2 = final.clone()
            f2[0, 0] = (carry * torch.exp(tot[0, 0, last])
                        + L[0, 0, last])
            yield (f"the carry into chunk {last} {name} (sample 0, head 0)",
                   *rerun(L, b2, f2))
    y = outputs(q, k, v, log_f, log_i, before, chunk)
    b2 = before.clone()
    b2[0, 0, nc - 1] = 0
    lost = outputs(q, k, v, log_f, log_i, b2, chunk)
    r0 = (nc - 1) * W + (W - 1) // GROUP * GROUP
    y[0, r0:nc * W, 0] = lost[0, r0:nc * W, 0]
    yield (f"the state read of rows {r0}-{nc * W} lost (sample 0, head 0)",
           y, final)
