"""Roofline analysis from dry-run records, for NVIDIA H100s (port of
``repro.launch.roofline``; the reference's peaks are a TPU's, these are
the H100 SXM's, NVIDIA's data sheet, dense, at the 700 W limit).

Per (arch x shape x mesh) cell, three per-chip time terms:

    T_compute = sum over dtypes of FLOPs / that dtype's peak
                (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32)
    T_memory  = (argument + output bytes) / HBM_bw      (3.35 TB/s)
    T_coll    = sum over the axes a rank's collectives span of their wire
                bytes / the slowest link their groups cross (0 on one
                chip)

Links (``link_bw``): ranks are laid out row-major over the mesh, as
``launch.mesh`` lays them out, 8 consecutive ranks to a node, as in
NVIDIA's DGX H100 reference layout. A group whose ranks all sit in one
node rides NVLink 4, 450 GB/s a direction a card (``LINK_BW``; 900 GB/s
both ways, the H100 SXM data sheet); any other group crosses the nodes'
network, one 400 Gb/s InfiniBand NDR port a card, 50 GB/s a direction
(``NET_BW``; the DGX H100's 8 ConnectX-7 ports). On the production meshes
that is every group: ``model`` = 16 comes last in row-major order, so
each ``model`` group spans two nodes, and ``data`` and ``pod`` groups
stride across nodes, so their T_coll is priced at 50 GB/s throughout.

Sources:
  * FLOPs are the dry run's counts (``hlo_stats.count``): the aten dots by
    input dtype, plus each kernel's operations by its own formula. The
    same rule bounds a single kernel call (:func:`kernel_bound`), so a
    kernel's bound and a cell's read the same work whatever implements it.
  * Memory traffic uses argument+output bytes — the perfect-fusion lower
    bound on HBM traffic (weights/caches/optimizer state read once,
    outputs written once); temp bytes are reported as footprint, not
    traffic.
  * Collective bytes are the ring model's wire bytes a rank moves
    (``hlo_stats.WIRE``), by the axes they cross
    (``collective_bytes_by_axes``).

MODEL_FLOPS (the "useful" numerator) = 6·N_active·tokens (train) or
2·N_active·tokens (serve), logical (unpadded) parameter counts.

roofline_fraction = ideal_time / bound_time, where
    ideal_time = max(MODEL_FLOPS_per_chip / peak, T_memory_ideal)
    bound_time = max(T_compute, T_memory, T_coll)
On the card a measured step time takes ``bound_time``'s place.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.configs.base import SHAPES_BY_NAME, ShapeSpec
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.launch.mesh import PRODUCTION, mesh_groups

PEAK_FLOPS = 989e12          # bf16 (and fp16) per chip, dense, tensor cores
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
PEAKS = {"bf16": PEAK_FLOPS, "f16": PEAK_FLOPS, "f32": FP32_FLOPS}
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s per direction, NVLink 4
NET_BW = 50e9                # bytes/s per direction, a 400 Gb/s NDR port
NODE = 8                     # cards a node, on one NVLink switch
HBM_BYTES = 80e9             # device memory
# the dry run's mesh names -> their shapes (axis -> size, in order)
MESH_SHAPES = {"1x1": {"data": 1, "model": 1},
               "16x16": PRODUCTION["single"],
               "pod2x16x16": PRODUCTION["multi"]}


def compute_time(flops_by_dtype: Dict[str, float]) -> float:
    """Seconds for these operations, each dtype at its own peak."""
    return sum(n / PEAKS[dt] for dt, n in flops_by_dtype.items())


def kernel_bound(work) -> Tuple[float, str]:
    """(least ms of one kernel call, ``"bytes"`` or ``"operations"``): the
    larger of its bytes over HBM_BW and its operations over their peaks
    (``repro_torch.kernels.Work``)."""
    t_bytes = work.bytes / HBM_BW * 1e3
    t_ops = compute_time(work.flops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def link_bw(shape: Dict[str, int], axes: Tuple[str, ...]) -> float:
    """Bytes/s a direction of the slowest link a group over ``axes`` of a
    ``shape`` mesh crosses: NVLink where every group lies in one node of
    ``NODE`` consecutive ranks, else the nodes' network."""
    one_node = all(len({r // NODE for r in ranks}) == 1
                   for names, ranks in mesh_groups(tuple(shape.values()),
                                                   tuple(shape))
                   if names == axes)
    return LINK_BW if one_node else NET_BW


def collective_time(hlo: dict, shape: Dict[str, int]) -> float:
    """T_coll of a record's counts on a ``shape`` mesh: each axes' wire
    bytes over its link."""
    return sum(b / link_bw(shape, tuple(ax.split(",")))
               for ax, b in hlo.get("collective_bytes_by_axes", {}).items())


@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    t_compute: float
    t_memory: float
    t_coll: float
    model_flops_chip: float
    hlo_flops_chip: float
    ideal_bytes_chip: float
    temp_gb: float
    args_gb: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return (self.model_flops_chip / self.hlo_flops_chip
                if self.hlo_flops_chip else 0.0)

    @property
    def ideal_time(self) -> float:
        return max(self.model_flops_chip / PEAK_FLOPS,
                   self.ideal_bytes_chip / HBM_BW)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_coll)

    @property
    def fraction(self) -> float:
        return self.ideal_time / self.bound_time if self.bound_time else 0.0

    def advice(self) -> str:
        d = self.dominant
        if d == "collective":
            return ("reduce cross-device traffic: fewer FSDP regathers / "
                    "all_to_all dispatch instead of token gather / "
                    "compressed reductions")
        if d == "compute" and self.useful_ratio < 0.5:
            return ("cut wasted FLOPs: causal block skipping, less remat "
                    "recompute, tighter MoE capacity, unpadded heads")
        if d == "compute":
            return "compute-bound near useful FLOPs: scale batch or chips"
        return ("memory-bound: shrink resident state (split-scan window "
                "caches, quantized KV, Adafactor) or raise arithmetic "
                "intensity (bigger batch)")


def _shape(shape: Union[str, ShapeSpec]) -> ShapeSpec:
    return SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape


def ideal_bytes_per_chip(arch: str, shape_name: Union[str, ShapeSpec],
                         chips: int) -> float:
    """Analytic HBM-traffic floor per chip using *logical* (unpadded) state:
    what a perfect implementation would move. Decode: active weights + the
    logical KV/recurrent state (window-bounded where the arch allows).
    Prefill: weights + logical cache written. Train: full optimizer-state
    read+write (28 B/param: bf16 p r/w + fp32 master/m/v r/w). A shape is
    a name of the registry or a ShapeSpec (a cell cut to size)."""
    cfg = ARCHITECTURES[arch]
    shape = _shape(shape_name)
    n = cfg.param_count()
    n_active = cfg.active_param_count()
    S, B = shape.seq_len, shape.global_batch
    hd = cfg.resolved_head_dim

    def cache_bytes(seq: int) -> float:
        per_layer = []
        for li in range(cfg.num_layers):
            if cfg.family == "ssm":
                per_layer.append(2 * cfg.num_heads * (2 * cfg.d_model // cfg.num_heads) ** 2 * 4)
                continue
            w = cfg.window if (cfg.window and li not in cfg.global_layers) else 0
            eff = min(seq, w) if w else seq
            per_layer.append(2 * eff * cfg.num_kv_heads * hd * 2)   # bf16 K+V
        if cfg.is_encoder_decoder:
            cross = 2 * seq * cfg.num_kv_heads * hd * 2
            self_ = 2 * (seq // cfg.decoder_ratio) * cfg.num_kv_heads * hd * 2
            return B * cfg.num_layers * (cross + self_)
        return B * sum(per_layer)

    if shape.kind == "train":
        return 28.0 * n / chips
    if shape.kind == "prefill":
        return (2.0 * n + cache_bytes(S)) / chips
    return (2.0 * n_active + cache_bytes(S)) / chips


def model_flops_per_chip(arch: str, shape_name: Union[str, ShapeSpec],
                         chips: int) -> float:
    cfg = ARCHITECTURES[arch]
    shape = _shape(shape_name)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.is_encoder_decoder:
            tokens = shape.global_batch * (shape.seq_len
                                           + shape.seq_len // cfg.decoder_ratio)
        return 6.0 * n_active * tokens / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / chips
    tokens = shape.global_batch           # one token per sequence
    return 2.0 * n_active * tokens / chips


def ideal_time(arch: str, shape: Union[str, ShapeSpec], chips: int = 1
               ) -> float:
    """Seconds a perfect implementation would take for one step."""
    return max(model_flops_per_chip(arch, shape, chips) / PEAK_FLOPS,
               ideal_bytes_per_chip(arch, shape, chips) / HBM_BW)


def flops_by_dtype(hlo: dict) -> Dict[str, float]:
    """A record's dot FLOPs and kernel operations, by dtype."""
    out = dict(hlo["dot_flops_by_dtype"])
    for w in hlo["kernel_work"].values():
        for dt, n in w["flops"].items():
            out[dt] = out.get(dt, 0.0) + n
    return out


def cell_from_record(rec: dict) -> CellRoofline:
    chips = rec["devices"]
    ma = rec["memory_analysis"]
    traffic = ma["argument_bytes"] + ma["output_bytes"]
    flops = flops_by_dtype(rec["hlo"])
    return CellRoofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        t_compute=compute_time(flops),
        t_memory=traffic / HBM_BW,
        t_coll=collective_time(rec["hlo"], MESH_SHAPES[rec["mesh"]]),
        model_flops_chip=model_flops_per_chip(rec["arch"], rec["shape"],
                                              chips),
        hlo_flops_chip=sum(flops.values()),
        ideal_bytes_chip=ideal_bytes_per_chip(rec["arch"], rec["shape"],
                                              chips),
        temp_gb=ma["temp_bytes"] / 1e9,
        args_gb=ma["argument_bytes"] / 1e9,
    )


def load_cell(path: Path) -> Optional[CellRoofline]:
    rec = json.loads(path.read_text())
    if not rec.get("ok"):
        return None
    return cell_from_record(rec)


def load_all(dryrun_dir: str, mesh: str = "single") -> List[CellRoofline]:
    """The ``ok`` records of one mesh: ``"one"`` (one device), ``"single"``
    (a rank of 16 x 16) or ``"multi"`` (of 2 x 16 x 16)."""
    if mesh not in ("one", "single", "multi"):
        raise ValueError(f"no mesh {mesh!r}: one, single or multi")
    cells = []
    for p in sorted(Path(dryrun_dir).glob(f"*__{mesh}.json")):
        c = load_cell(p)
        if c:
            cells.append(c)
    return cells


def fmt_ms(t: float) -> str:
    if t >= 1.0:
        return f"{t:.2f}s"
    return f"{t*1e3:.2f}ms"


def table(cells: List[CellRoofline]) -> str:
    hdr = ("| arch | shape | T_comp | T_mem | T_coll | dominant | "
           "useful/HLO | frac | state GB/chip | note |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for c in cells:
        lines.append(
            f"| {c.arch} | {c.shape} | {fmt_ms(c.t_compute)} | "
            f"{fmt_ms(c.t_memory)} | {fmt_ms(c.t_coll)} | **{c.dominant}** | "
            f"{c.useful_ratio:.2f} | {c.fraction:.2f} | {c.args_gb:.1f} | "
            f"{c.advice()[:48]} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun/baseline")
    ap.add_argument("--mesh", default="single",
                    choices=["one", "single", "multi"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    cells = load_all(args.dryrun, args.mesh)
    print(table(cells))
    worst = sorted(cells, key=lambda c: c.fraction)[:5]
    print("\nworst roofline fractions (hillclimb candidates):")
    for c in worst:
        print(f"  {c.arch} x {c.shape}: frac={c.fraction:.3f} "
              f"dominant={c.dominant} — {c.advice()}")
    coll_bound = sorted(cells, key=lambda c: -c.t_coll / max(c.bound_time, 1e-12))[:5]
    print("\nmost collective-bound:")
    for c in coll_bound:
        print(f"  {c.arch} x {c.shape}: T_coll={fmt_ms(c.t_coll)} "
              f"({c.t_coll/max(c.bound_time,1e-12)*100:.0f}% of bound)")
    if args.json:
        out = [dict(arch=c.arch, shape=c.shape, mesh=c.mesh,
                    t_compute=c.t_compute, t_memory=c.t_memory,
                    t_coll=c.t_coll, dominant=c.dominant,
                    useful_ratio=c.useful_ratio, fraction=c.fraction)
               for c in cells]
        Path(args.json).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
