"""``chip_smoke.py`` phase 14's card work alone: the new kernel shapes
against their plain versions (``LONG_CASES``), flash at S=32,768 against
SDPA, and the four ``LAUNCH_CELLS`` through ``launch.steps.build_step``
(without the background dry run of all 32 cells). A failing cell is
reported and the next one runs.

    python3 scripts/launch_cells.py

Needs a CUDA device; builds the kernels from the checkout."""

import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("launch_cells: needs a CUDA device")
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    with torch.no_grad():
        rows = ([cs._decode_case(dev, randn, *c)
                 for c in cs.LONG_CASES["decode_attention"]]
                + [cs._flash_case(dev, randn, **c)
                   for c in cs.LONG_CASES["flash_attention"]]
                + [cs.flash_vs_sdpa(dev)])
    for r in rows:
        cs.log(json.dumps(r, default=str))
    failed = 0
    for arch, shape, batch, steps, kernels in cs.LAUNCH_CELLS:
        t1 = time.perf_counter()
        try:
            c = cs.card_cell(dev, arch, shape, batch, steps, kernels)
            cs.log(f"cell {arch} x {shape}: " + json.dumps(c, default=str))
        except Exception as e:  # noqa: BLE001 - reported, the next runs
            traceback.print_exc()
            cs.log(f"cell {arch} x {shape} FAILED: {e!r}"[:3000])
            failed += 1
        cs.log(f"  {time.perf_counter() - t1:.1f} s")
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
