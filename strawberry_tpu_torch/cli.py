"""Command-line interface of the PyTorch/CUDA port: the same flags as
strawberry_tpu.cli (its parser and config are reused), with the device
work on the GPU: the per-locus EM under --fast-em or STRAWB_DEVICE_EM=1,
pass-2 quant prep under STRAWB_DEVICE_PREP=all|budget, and the pass-1 flow
solves under STRAWB_DEVICE_MCF=1.

    python -m strawberry_tpu_torch.cli -g ann.gtf [-r] [--fast-em] in.bam

The distributed launches (--shards, STRAWB_DIST_NPROCS > 1) are not ported
yet and are refused.
"""
from __future__ import annotations

import os
import sys

from strawberry_tpu.cli import build_parser, config_from_args

from .pipeline import run_driver


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.shards > 0:
        print("--shards is not supported by strawberry_tpu_torch yet "
              "(ROADMAP.md queue 1 item 7); run strawberry_tpu.cli for the "
              "sharded simulation", file=sys.stderr)
        return 2
    if int(os.environ.get("STRAWB_DIST_NPROCS", "1")) > 1:
        print("STRAWB_DIST_NPROCS > 1: multi-host runs are not supported "
              "by strawberry_tpu_torch yet (ROADMAP.md queue 1 item 7)",
              file=sys.stderr)
        return 2

    if os.path.exists(cfg.output_gtf):
        print(f"{cfg.output_gtf} exists! Exit.", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(cfg.output_gtf)),
                exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(cfg.logfile)), exist_ok=True)

    cmdline = " ".join(["strawberry-tpu-torch"] + (argv or sys.argv[1:]))
    with open(cfg.output_gtf, "w") as out, open(cfg.logfile, "w") as log:
        out.write(f"#{cmdline} \n")
        out.write("#########################################\n")
        fragfh = open(cfg.frag_context_out, "w") \
            if cfg.print_frag_context else None
        try:
            run_driver(args.bam, cfg, out, log, fragfh, cmdline)
        except IOError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        finally:
            if fragfh:
                fragfh.close()
    print("Program finished")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
