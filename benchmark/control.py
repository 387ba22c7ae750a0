"""The readings the limits of ``benchmark/limits/<cell>.json`` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        --control-seeds 11,12,13 --seconds 1 [--out FILE]

For each seed, in one process: the program's numbers, from a run of the
cell at its own size cut to a short window (``--seconds``; the window still
finishes whole batches), compared with the float32 reference exactly as a
benchmark run compares them (the lower readings); and for the control
seeds, the control's numbers: the reference computed in the precision below
the configuration's (float8 e4m3 products in place of bfloat16, bfloat16 in
place of the float32 image stages) put in the program's place, at each
position of the same prompts and tokens (the upper readings). One JSON line
a seed on standard output, and in ``--out``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from benchmark.harness import cell_parts, load_json, make_driver, window

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    bench = load_json(ROOT / "BENCHMARK.json")
    _cell, config, mix = cell_parts(bench, args.workload)
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    out_f = open(args.out, "a") if args.out else None
    try:
        for s in [int(x) for x in args.seeds.split(",")]:
            t0 = time.perf_counter()
            driver = make_driver(config, mix, s, dev)
            driver.warm_up()
            done, failed, _walls, window_s, n = window(driver, args.seconds, dev)
            if hasattr(driver, "close_window"):
                driver.close_window()
            torch.cuda.empty_cache()
            line = {"workload": args.workload, "seed": s, "batches": n, "failed": failed,
                    "card": torch.cuda.get_device_name(dev),
                    "program": driver.check(n, np.random.default_rng([s % 2**63, 9]))}
            if s in ctl_seeds:
                line["control"] = driver.check(n, np.random.default_rng([s % 2**63, 9]),
                                               precision="fp8", control=True)
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            if out_f:
                out_f.write(json.dumps(line) + "\n")
                out_f.flush()
            del driver          # the backend's wrapped call refers back to it
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out_f:
            out_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
