"""``chip_smoke.py`` phase 16 alone: the sharded paths on one card (16a an
NCCL world of one rank; 16b-l four gloo ranks sharing the card, 16l each
rank's count against its counting rank's), with the seconds each rank
spent in each sub-phase.

    python3 scripts/sharded_phases.py

Needs a CUDA device; builds the kernels from the checkout. The ranks are
spawned processes that import this file again, so its work runs only
under ``__main__``."""

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("sharded_phases: needs a CUDA device")
    t0 = time.perf_counter()
    _build.build()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    counts = cs.sharded_phases(torch.device("cuda"))
    cs.log(f"launches on the sharded paths {counts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
