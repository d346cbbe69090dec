"""The planted inputs that hold the chunked ssd_scan kernel to its plain
version (``repro_torch.kernels.ssd_scan.probe``), on the CPU: the kernel's
decomposition (each chunk's local state, the scan over chunks, each chunk's
y from the state before it) written in plain torch is the plain version's
function; under hymba's own gates a lost chunk or a lost state read passes
the check that ``chip_smoke.py::scan_cases`` applies; on planted inputs the
final state depends on every chunk and every fault ``probe.faults`` models
fails that check."""

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import probe
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.linear_core import pad_mask_gates

BF16_ULP = 2.0 ** -7
# the kernel check's tolerance (chip_smoke.py SCAN_ATOL, tests/
# test_torch_cuda.py): y to one bf16 rounding, the fp32 state to rtol 2e-5,
# each plus SCAN_ATOL of its largest magnitude
SCAN_ATOL = 2e-5

B, S, H, DK, DV, W = 2, 1024, 3, 16, 64, 256


def _fails(y, state, yr, sr):
    """Which of y and the state fail the kernel check against (yr, sr)."""
    out = []
    for got, want, rtol in ((y, yr, BF16_ULP), (state, sr, 2e-5)):
        g, w = got.float(), want.float()
        atol = SCAN_ATOL * float(w.abs().max())
        out.append(bool(((g - w).abs() > atol + rtol * w.abs()).any()))
    return out


def _hymba_inputs(gen):
    """N(0, 1) q, k, v and the gates hymba's SSD makes at initialisation
    (dt = softplus(N(0, 1)))."""
    q, k = (torch.randn((B, S, H, DK), generator=gen).bfloat16()
            for _ in range(2))
    v = torch.randn((B, S, H, DV), generator=gen).bfloat16()
    dt = F.softplus(torch.randn((B, S, H), generator=gen))
    return q, k, v, -dt, torch.log(dt)


def _planted(gen, lens=(S, 700)):
    q, k, v, lf, li = probe.planted(gen, B, S, H, DK, DV, W, "cpu")
    lf, li = pad_mask_gates(lf, li, torch.tensor(lens))
    return q, k, v, lf, li


@pytest.mark.parametrize("inputs", ["hymba", "planted"])
@pytest.mark.parametrize("state", [False, True])
def test_decomposition_is_the_plain_version(inputs, state):
    """Local states, the scan over chunks and the state reads, in plain
    torch, against ``ssd_scan_ref`` with pad-masked gates (sample 1 padded
    past 700 of 1,024) and a zero or nonzero initial state."""
    gen = torch.Generator().manual_seed(11)
    if inputs == "planted":
        q, k, v, lf, li = _planted(gen)
    else:
        q, k, v, lf, li = _hymba_inputs(gen)
        lf, li = pad_mask_gates(lf, li, torch.tensor([S, 700]))
    s0 = torch.randn((B, H, DK, DV), generator=gen) if state else None
    yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=W, initial_state=s0)
    y, st = probe.decomposed(q, k, v, lf, li, chunk=W, initial_state=s0)
    assert _fails(y, st, yr, sr) == [False, False]
    # and each chunk's y reads the state before it
    L, tot = probe.local_states(k, v, lf, li, W)
    before, final = probe.carries(L, tot, s0)
    assert torch.equal(final, st)
    if s0 is not None:
        assert torch.equal(before[:, :, 0], s0)


def test_hymba_gates_cannot_see_a_lost_chunk():
    """Why the card's check plants: under hymba's own gates the state
    forgets a chunk within some 30 positions, so a final state without
    chunk 0's local state, and a row group without its state read, pass
    the check; on planted inputs both fail it."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, lf, li = _hymba_inputs(gen)
    yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=W)
    seen = {name: _fails(y, st, yr, sr)
            for name, y, st in probe.faults(q, k, v, lf, li, chunk=W)}
    assert seen["chunk 0's local state lost (sample 0, head 0)"][1] is False
    read = [n for n in seen if n.startswith("the state read")]
    assert seen[read[0]] == [False, False]
    q, k, v, lf, li = _planted(gen)
    yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=W)
    for name, y, st in probe.faults(q, k, v, lf, li, chunk=W):
        if name.startswith(("chunk 0", "the state read")):
            assert any(_fails(y, st, yr, sr)), name


def test_planted_final_state_depends_on_every_chunk():
    """Each chunk's local state lost in one (b, h), for every chunk: the
    final state fails the check there, all through the chunk's planted
    column, and nowhere else; a chunk that is all padding (sample 1 past
    700) has nothing to lose."""
    lens = (S, 700)
    gen = torch.Generator().manual_seed(7)
    q, k, v, lf, li = _planted(gen, lens)
    s0 = torch.randn((B, H, DK, DV), generator=gen)
    _, sr = ssd_scan_ref(q, k, v, lf, li, chunk=W, initial_state=s0)
    L, tot = probe.local_states(k, v, lf, li, W)
    atol = SCAN_ATOL * float(sr.abs().max())
    for c in range(S // W):
        for b in range(B):
            lost = L.clone()
            lost[b, 1, c] = 0
            _, final = probe.carries(lost, tot, s0)
            bad = (final - sr).abs() > atol + 2e-5 * sr.abs()
            if c * W < lens[b]:
                assert bad[b, 1, :, c % DV].all(), (c, b)
                bad[b, 1] = False
            assert not bad.any(), (c, b)


# (B, S, H, dk, dv, chunk, padded lengths, initial state): hymba's width at
# 4 chunks, the ragged edges (dk 20, dv 65, a chunk of 200, 2 chunks)
PROBE_CASES = [(2, 1024, 3, 16, 64, 256, (1024, 700), True),
               (2, 1024, 3, 16, 64, 256, (1024, 1024), False),
               (1, 600, 2, 20, 65, 200, (600,), True),
               (2, 512, 2, 16, 64, 256, (512, 300), True)]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_planted_faults_fail_the_check(case):
    Bc, Sc, Hc, dk, dv, chunk, lens, state = case
    gen = torch.Generator().manual_seed(13)
    q, k, v, lf, li = probe.planted(gen, Bc, Sc, Hc, dk, dv, chunk, "cpu")
    lf, li = pad_mask_gates(lf, li, torch.tensor(lens))
    s0 = torch.randn((Bc, Hc, dk, dv), generator=gen) if state else None
    yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=chunk, initial_state=s0)
    names = []
    for name, y, st in probe.faults(q, k, v, lf, li, chunk=chunk,
                                    initial_state=s0):
        assert any(_fails(y, st, yr, sr)), name
        names.append(name)
    assert len(names) == 6
