"""Perf probe: count one dry-run cell and print where its work goes — the
port's counterpart of `repro/launch/perfprobe.py`.

Prints the roofline (`launch/dryrun.py`, at the H100's rates), the
collectives by kind, the argument and temp bytes, the matmul flops by
function of `repro_torch` (`op_analysis.OpCount.flops_breakdown`) with
their shares, and the hand-written kernels' launches and work by kernel.
`--dump-ops PATH` writes the op table (calls, flops and bytes of each aten
op) as JSON; the reference's `--dump-hlo` has no counterpart.

Usage: python -m repro_torch.launch.perfprobe --arch granite-20b \\
           --shape train_4k --attn fastmax2-kernel
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import dryrun as dr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(dr.SHAPES))
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--attn", default=None)
    ap.add_argument("--cp", type=int, default=1)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--dump-ops", default=None)
    args = ap.parse_args(argv)

    res = dr.run_cell(args.arch, args.shape, multi_pod=args.multi,
                      attn=args.attn, cp=args.cp,
                      keep_ops=args.dump_ops is not None)
    if "skipped" in res:
        print(res["skipped"])
        return
    print(json.dumps(res["roofline"], indent=2))
    print({k: f"{v:.3e}" for k, v in res["ops"].items()
           if k.startswith("coll_") and v})
    ex = res["executed"]
    print(f"argbytes/dev={ex['argument_bytes']} "
          f"temp/dev={ex['temp_peak_bytes']} "
          f"planned/dev={res['planned']['total']}")
    total = res["ops"]["matmul_flops"]
    print(f"\nper-device matmul flops: {total:.3e}; breakdown:")
    for site, fl in res["flops_breakdown"][:args.top]:
        print(f"  {fl:12.3e} ({100 * fl / max(total, 1):5.1f}%)  {site[:110]}")
    print(f"\nkernels (operations, bytes) per device: "
          f"{res['ops']['kernel_ops']:.3e} ops, "
          f"{res['ops']['kernel_bytes']:.3e} bytes")
    for name, w in sorted(res["kernel_work"].items()):
        print(f"  {name}: {w['launches']} launches, {w['ops']:.3e} ops, "
              f"{w['bytes']:.3e} bytes")
    if args.dump_ops:
        with open(args.dump_ops, "w") as f:
            json.dump(res["op_table"], f, indent=1)


if __name__ == "__main__":
    main()
