"""The readings that a cell's correctness limits are set from, on the card, at
the cell's own size, in one process:

    python3 benchmark/control.py --workload <cell> --first-seed <n> --seeds 12 \
        --control-seeds 3 [--seconds 1] [--out FILE]

- the program's numbers on ``--seeds`` seeds (each a whole run of the cell
  at a short window: set-up, window, check), the lower readings;
- the control's on ``--control-seeds`` seeds: the cell's family's
  reference put in the program's place and computed in its ``CONTROL``
  precision (float8 e4m3 operands, one step below the configuration's
  bfloat16; inference: the whole batch by the family's ``detect``;
  training: the two followings of three steps, the set-up's and the
  window's);
- training only, the fault "half of the batch left out, the mean taken over
  the rest": the f32 reference in the program's place over the first half
  of each batch.
A state left unchanged reads 1 in ``update_gap`` by its definition and
needs no run. One JSON line a reading on standard output (and in ``--out``);
the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_entry(fam):
    """An ``infer_batch`` stand-in: the detector family ``fam``'s reference
    computes the batch in its ``CONTROL`` precision from the weights the
    program was given."""
    import dataclasses

    cache = {}

    def entry(model, cfg, raw, hw, dtype):
        if "W" not in cache:
            cache["W"] = {k: v.float() for k, v in model.state_dict().items()}
            cache["m"] = json.loads(json.dumps(dataclasses.asdict(cfg)))
        return fam.detect(cache["W"], cache["m"], raw, hw, fam.CONTROL)

    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cell, check, spec

    sp = spec.cell(args.workload)
    fam = sp["family"]
    mode = sp["traffic"]["mode"]
    lines = []

    def emit(kind, seed, numbers, t0):
        line = {"cell": args.workload, "kind": kind, "seed": seed, "seconds": round(time.perf_counter() - t0, 1),
                **{k: v for k, v in numbers.items() if isinstance(v, (int, float, str)) or v is None}}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for n in range(args.seeds):
        seed = args.first_seed + n
        t0 = time.perf_counter()
        extra = {}
        cell.run(sp, seed, args.seconds, False, args.device, t0, extra=extra)
        emit("program", seed, extra["numbers"], t0)
        if mode == "train" and n < args.control_seeds:
            for kind, prec, images in (("control_fp8", fam.CONTROL, None),
                                       ("fault_half_batch", fam.F32, range(sp["traffic"]["batch"] // 2))):
                t0 = time.perf_counter()
                nums = check.judge_followings(fam, sp["config"]["model"], extra, prec, images,
                                              steps_per_epoch=cell.STEPS_PER_EPOCH)
                emit(kind, seed, nums, t0)
        extra.clear()
        torch.cuda.empty_cache()
    if mode == "infer":
        csp = copy.deepcopy(sp, {id(fam): fam})
        csp["traffic"].update(warmup_batches=0, min_batches=sp["traffic"]["check_batches"])
        for n in range(args.control_seeds):
            seed = args.first_seed + n
            t0 = time.perf_counter()
            extra = {}
            cell.run(csp, seed, 0.0, False, args.device, t0, extra=extra, entry=control_entry(fam))
            emit("control_fp8", seed, extra["numbers"], t0)
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
