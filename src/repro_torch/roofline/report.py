"""Render the roofline tables from the dry-run's records (port of
``repro.roofline.report``, over ``experiments/dryrun_torch``).

    PYTHONPATH=src python -m repro_torch.roofline.report [--tag baseline] [--mesh 16x16]

The port's ``compile_s`` is the seconds its trace of the step took (there is
no compile), shown in the ``trace`` column.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

_SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load(tag: str = "baseline", out_dir: str = "experiments/dryrun_torch"):
    recs = []
    for fn in glob.glob(os.path.join(out_dir, tag, "*.json")):
        with open(fn) as f:
            recs.append(json.load(f))
    recs.sort(key=lambda r: (r["arch"], _SHAPE_ORDER.get(r["shape"], 9), r["mesh"]))
    return recs


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def table(recs, mesh: str = "16x16") -> str:
    rows = [
        "| arch | shape | compute | memory | collective | dominant | useful FLOPs | trace |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        t = r["roofline"]
        u = r.get("useful_flops_ratio")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"{t['dominant'].replace('_s', '')} | {u:.3f} | {r['compile_s']:.0f}s |"
            if u is not None
            else f"| {r['arch']} | {r['shape']} | - | - | - | - | - | {r['compile_s']:.0f}s |"
        )
    return "\n".join(rows)


def multi_pod_table(recs) -> str:
    rows = [
        "| arch | shape | trace | collectives (AR/AG/RS/A2A/CP) | coll bytes/dev |",
        "|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != "2x16x16":
            continue
        c = r["raw_collectives"]["counts"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['compile_s']:.0f}s | "
            f"{c['all-reduce']}/{c['all-gather']}/{c['reduce-scatter']}/"
            f"{c['all-to-all']}/{c['collective-permute']} | "
            f"{r['raw_collectives']['total_bytes']/1e6:.1f}MB |"
        )
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    recs = load(args.tag, args.out)
    print(f"### Roofline ({args.mesh}, tag={args.tag}, {len(recs)} records)\n")
    print(table(recs, args.mesh))
    if any(r["mesh"] == "2x16x16" for r in recs):
        print("\n### Multi-pod (2x16x16) trace proof\n")
        print(multi_pod_table(recs))


if __name__ == "__main__":
    main()
