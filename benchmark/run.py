"""One run of one benchmark cell on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object) and
the numbers that decide ``correct`` beside their limits as the last lines
of standard error. Exits with another code than 0, and prints no result,
without a CUDA card (or with fewer than the cell asks for), or if a module
of JAX or of the JAX package was loaded. The cell's files are found by name
(``benchmark/spec.py``). Build and kernel caches stay in fixed directories
of the checkout (the port's ``mxdetection_tpu_torch/_build``). The process
runs torch's CPU work on one thread, so that no pool of worker threads
shares the host's cores with the thread that launches the card's work.
"""

import os
import sys
import time

PROC_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "mxdetection_tpu_torch", "_build")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cell, spec

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)

    sp = spec.cell(args.workload)
    chips = sp["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cell.log(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}")
        return 2
    out = cell.run(sp, args.seed, args.seconds, bool(args.trace), "cuda:0", PROC_START)
    found = cell.forbidden_modules()
    if found:
        cell.log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
