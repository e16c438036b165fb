"""The dry run's and the roofline's tables over ``results/dryrun_torch``
(the port of ``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report [--results DIR] > tables.md

Every figure is a count at data-sheet constants (``launch.roofline.H100``),
not a measurement.
"""

from __future__ import annotations

import argparse

from repro_torch.launch.roofline import H100, Chip, analyse, fmt_s, load_records

__all__ = ["dryrun_table", "roofline_table", "HINTS", "main"]

HINTS = {
    ("memory", "decode"): "bigger per-step batch amortizes cache reads; int8 KV",
    ("memory", "train"): "fewer f32 round-trips; larger per-device batch",
    ("memory", "prefill"): "windowed key slicing; bf16 score tensors",
    ("memory", "search"): "bf16 corpus; tile-level early exit (Pallas kernel)",
    ("collective", "train"): "reduce-scatter MoE/TP partials; bf16 collectives; EP",
    ("collective", "prefill"): "head-sharded attention to kill SP re-gathers",
    ("collective", "decode"): "replicate small params instead of FSDP gathers",
}


def dryrun_table(mesh: str, results: str | None = None) -> str:
    out = [
        f"### Mesh `{mesh}`\n",
        "| arch | shape | kind | HBM/dev raw | HBM/dev held* | census FLOPs/dev | "
        "census bytes/dev | collective B/dev | dry run |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in load_records(mesh, results):
        if rec.get("status") == "skipped":
            out.append(
                f"| {rec['arch']} | {rec['shape']} | — | skipped: "
                f"{rec['reason'][:48]} | — | — | — | — | — |")
            continue
        if rec.get("status") != "ok":
            out.append(f"| {rec['arch']} | {rec['shape']} | — | ERROR | — | — | — | — | — |")
            continue
        m = rec["memory"]
        tot = (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]) / 2**30
        # Held at once: aliased outputs are the arguments updated in place.
        held = (m["argument_bytes"] + max(m["output_bytes"] - m["alias_bytes"], 0)
                + m["temp_bytes"]) / 2**30
        cen = rec.get("census", {})
        out.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['kind']} | "
            f"{tot:.2f} GiB | {held:.2f} GiB | {cen.get('flops', 0):.3g} | "
            f"{cen.get('bytes', 0):.3g} | {cen.get('collective_bytes', 0):.3g} | "
            f"{rec.get('compile_s', 0)}s |")
    out.append(f"\n*held = args + (out − aliased) + temp, against the {H100.name}'s "
               f"{H100.hbm_bytes / 1e9:.0f} GB; temp is one (data, model) rank's step with "
               f"its model pieces whole along 'data' (counts, not measurements).")
    return "\n".join(out)


def roofline_table(mesh: str, results: str | None = None, chip: Chip = H100) -> str:
    out = [
        f"### Mesh `{mesh}` ({chip.name}: {chip.peak_bf16 / 1e12:.0f} TF/s bf16, "
        f"{chip.peak_fp32 / 1e12:.0f} TF/s fp32, {chip.peak_int8 / 1e12:.0f} TOP/s int8, "
        f"{chip.hbm_bw / 1e9:.0f} GB/s HBM, {chip.link_bw_cross / 1e9:.0f} GB/s a card "
        f"across nodes; data-sheet counts)\n",
        "| arch | shape | compute | memory | collective | dominant | useful% | "
        "roofline% | what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in load_records(mesh, results):
        a = analyse(rec, chip)
        if a is None:
            out.append(
                f"| {rec['arch']} | {rec['shape']} | — | — | — | "
                f"{rec.get('status')}: {rec.get('reason', '')[:42]} | — | — | — |")
            continue
        u = f"{100 * a.get('useful_ratio', 0):.1f}" if "useful_ratio" in a else "—"
        rf = f"{100 * a.get('roofline_frac', 0):.2f}" if "roofline_frac" in a else "—"
        hint = HINTS.get((a["dominant"], rec.get("kind", "")), "—")
        out.append(
            f"| {a['arch']} | {a['shape']} | {fmt_s(a['t_compute_s']).strip()} | "
            f"{fmt_s(a['t_memory_s']).strip()} | {fmt_s(a['t_collective_s']).strip()} | "
            f"{a['dominant']} | {u} | {rf} | {hint} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=None, help="the dry run's records")
    args = ap.parse_args(argv)
    for mesh in ("pod16x16", "pod2x16x16"):
        print(f"\n## Dry-run — {mesh}\n")
        print(dryrun_table(mesh, args.results))
    print("\n## Roofline — single pod\n")
    print(roofline_table("pod16x16", args.results))


if __name__ == "__main__":
    main()
