"""Roofline analysis over the dry-run records (the port of
``repro.launch.roofline``).

Per (arch x shape x mesh) cell, from the record's per-device census
(``launch.dryrun``; ``launch.op_census``):

    compute term    = sum over classes of FLOPs_per_device[class] / peak[class]
    memory term     = bytes_per_device / HBM bandwidth
    collective term = collective_bytes_per_device / link bandwidth

plus MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for the useful-compute
ratio.  The bound is the largest term.  The chip's constants are the H100
SXM's data-sheet peaks at 700 W (:data:`H100`): dense bf16 989 TFLOP/s,
float32 outside the tensor cores 67 TFLOP/s (the port keeps TF32 off),
int8 1,979 TOP/s, 3.35 TB/s of HBM; a collective group inside one 8-card
node moves 450 GB/s a direction over NVLink, one that spans nodes (the
production layouts' 16- and 256-rank groups) 50 GB/s, one 400 Gb/s NIC a
card.  These are counts at data-sheet constants, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod16x16] [--md]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.launch.specs import SHAPES

__all__ = ["Chip", "H100", "TPU_V5E", "PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS", "PEAK_INT8_OPS",
           "PEAK_BYTES", "PEAK_FP32_INSTR", "LINK_BW", "param_count", "model_flops", "analyse",
           "load_records", "fmt_s", "RESULTS"]

RESULTS = os.path.join(os.path.dirname(__file__), "../../../results/dryrun_torch")


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator's peaks: operations a second by class (``bf16``,
    ``fp32``, ``int8``), bytes a second of its memory, and its collective
    links a direction inside one node of ``node_size`` cards and across
    nodes."""

    name: str
    peak_bf16: float
    peak_fp32: float
    peak_int8: float
    hbm_bw: float
    link_bw_node: float
    link_bw_cross: float
    node_size: int
    hbm_bytes: float

    def peak(self, cls: str) -> float:
        return {"bf16": self.peak_bf16, "fp32": self.peak_fp32, "int8": self.peak_int8}[cls]

    def link_bw(self, group: int) -> float:
        """The rate of a collective over ``group`` ranks (0: unknown, taken
        to span nodes)."""
        return self.link_bw_node if 0 < group <= self.node_size else self.link_bw_cross


# NVIDIA H100 SXM 80 GB data sheet, dense peaks at 700 W.
H100 = Chip("H100 SXM", peak_bf16=989e12, peak_fp32=67e12, peak_int8=1979e12,
            hbm_bw=3.35e12, link_bw_node=450e9, link_bw_cross=50e9, node_size=8,
            hbm_bytes=80e9)
# The reference's constants, one peak for every class; for holding
# :func:`analyse` against the reference's only.
TPU_V5E = Chip("TPU v5e", peak_bf16=197e12, peak_fp32=197e12, peak_int8=197e12,
               hbm_bw=819e9, link_bw_node=50e9, link_bw_cross=50e9, node_size=256,
               hbm_bytes=16e9)

PEAK_BF16_FLOPS = H100.peak_bf16
PEAK_FP32_FLOPS = H100.peak_fp32
PEAK_INT8_OPS = H100.peak_int8
PEAK_BYTES = H100.hbm_bw
LINK_BW = {"node": H100.link_bw_node, "cross": H100.link_bw_cross}
# fp32 instructions a second of one H100 SXM at its 1.98 GHz boost clock
# (128 lanes x 132 SMs): the rate of separate rounded multiplies and adds,
# half the FMA-counted PEAK_FP32_FLOPS.
PEAK_FP32_INSTR = 128 * 132 * 1.98e9


def param_count(arch: str) -> tuple[float, float]:
    """(total_params, active_params) from the config (analytic)."""
    cfg = get_config(arch)
    d, v = cfg.d_model, cfg.vocab_padded
    embed = v * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        return d * cfg.qkv_dim * 2 + d * cfg.kv_dim * 2

    def mlp_params(f):
        mult = 3 if cfg.activation in ("silu", "geglu") else 2
        return mult * d * f

    total = active = embed
    if cfg.family in ("dense",):
        per = attn_params() + mlp_params(cfg.d_ff)
        total += cfg.num_layers * per
        active = total
    elif cfg.family == "moe":
        f = cfg.moe_d_ff or cfg.d_ff
        shared = mlp_params(cfg.shared_d_ff) if cfg.shared_d_ff else 0
        per_tot = attn_params() + cfg.num_experts * mlp_params(f) + shared
        per_act = attn_params() + cfg.experts_per_tok * mlp_params(f) + shared
        total += cfg.num_layers * per_tot
        active += cfg.num_layers * per_act
    elif cfg.family == "ssm":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = d * (2 * di + 2 * n + h) + di * d + (cfg.ssm_conv + 1) * (di + 2 * n)
        total += cfg.num_layers * per
        active = total
    elif cfg.family == "hybrid":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = d * (2 * di + 2 * n + h) + di * d + (cfg.ssm_conv + 1) * (di + 2 * n)
        total += cfg.num_layers * per + attn_params() + mlp_params(cfg.d_ff)
        active = total  # shared block re-executes; params shared
    elif cfg.family == "encdec":
        per = attn_params() + mlp_params(cfg.d_ff)
        dec = per + attn_params()  # + cross attention
        total += cfg.encoder_layers * per + cfg.num_layers * dec
        active = total
    elif cfg.family == "vlm":
        per = attn_params() + mlp_params(cfg.d_ff)
        n_cross = cfg.num_layers // cfg.cross_every
        total += cfg.num_layers * per + n_cross * (attn_params() + mlp_params(cfg.d_ff))
        active = total
    return float(total), float(active)


def model_flops(arch: str, shape: str) -> float:
    """MODEL_FLOPS = 6·N_active·D(tokens) for train; 2·N·D for inference."""
    total, active = param_count(arch)
    spec = SHAPES[shape]
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq
        return 6.0 * active * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * spec.global_batch


def load_records(mesh: str, results: str | None = None) -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(results or RESULTS, mesh, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def analyse(rec: dict, chip: Chip = H100) -> dict | None:
    """The reference's terms, keys and dominant-term rule at ``chip``'s
    constants; the compute term sums each class of the census's
    ``flops_by_class`` over its own peak (a record without the split: all
    of it at the bf16 peak, as the reference's one peak)."""
    if rec.get("status") != "ok":
        return None
    arch, shape = rec["arch"], rec["shape"]
    cen = rec.get("census", {})
    if cen and "flops" in cen:
        flops_dev = cen["flops"]
        bytes_dev = cen["bytes"]
        coll_dev = cen["collective_bytes"]
        by_class = cen.get("flops_by_class")
    else:
        flops_dev = rec["cost"]["flops"]
        bytes_dev = rec["cost"]["bytes_accessed"]
        coll_dev = rec["collectives"]["total_bytes"]
        by_class = rec["cost"].get("flops_by_class")
    if by_class:
        t_compute = sum(v / chip.peak(c) for c, v in by_class.items())
    else:
        t_compute = flops_dev / chip.peak_bf16
    t_memory = bytes_dev / chip.hbm_bw
    t_coll = coll_dev / chip.link_bw(rec.get("group_ranks", 0))
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    out = {
        "arch": arch, "shape": shape, "mesh": rec["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "bound_s": max(terms.values()),
    }
    if arch != "dade-ivf":
        mf = model_flops(arch, shape)
        hlo_total = flops_dev * rec["devices"]
        out["model_flops"] = mf
        out["hlo_flops_total"] = hlo_total
        out["useful_ratio"] = mf / hlo_total if hlo_total else 0.0
        # fraction of roofline: useful work per sec at the bound vs peak
        out["roofline_frac"] = (
            (mf / rec["devices"] / max(terms.values())) / chip.peak_bf16
            if max(terms.values()) > 0 else 0.0
        )
    return out


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:7.2f}s "
    if x >= 1e-3:
        return f"{x*1e3:7.2f}ms"
    return f"{x*1e6:7.2f}us"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--md", action="store_true", help="markdown table output")
    ap.add_argument("--results", default=None,
                    help=f"the dry run's records (default {os.path.normpath(RESULTS)})")
    args = ap.parse_args(argv)

    rows = []
    for rec in load_records(args.mesh, args.results):
        a = analyse(rec)
        if a is None:
            rows.append((rec["arch"], rec["shape"], rec.get("status"),
                         rec.get("reason", rec.get("error", ""))[:60]))
            continue
        rows.append(a)

    if args.md:
        print("| arch | shape | compute | memory | collective | dominant | "
              "useful% | roofline% |")
        print("|---|---|---|---|---|---|---|---|")
    else:
        print(f"{'arch':24s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
              f"{'coll':>10s} {'dominant':>10s} {'useful%':>8s} {'roof%':>7s}")
    for r in rows:
        if isinstance(r, tuple):
            if args.md:
                print(f"| {r[0]} | {r[1]} | — | — | — | {r[2]}: {r[3]} | — | — |")
            else:
                print(f"{r[0]:24s} {r[1]:12s} {r[2]}: {r[3]}")
            continue
        u = f"{100*r.get('useful_ratio', 0):.1f}" if "useful_ratio" in r else "—"
        rf = f"{100*r.get('roofline_frac', 0):.1f}" if "roofline_frac" in r else "—"
        if args.md:
            print(f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute_s'])} | "
                  f"{fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} | "
                  f"{r['dominant']} | {u} | {rf} |")
        else:
            print(f"{r['arch']:24s} {r['shape']:12s} {fmt_s(r['t_compute_s']):>10s} "
                  f"{fmt_s(r['t_memory_s']):>10s} {fmt_s(r['t_collective_s']):>10s} "
                  f"{r['dominant']:>10s} {u:>8s} {rf:>7s}")


if __name__ == "__main__":
    main()
