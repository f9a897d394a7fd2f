"""Read the numbers that decide ``correct`` on the card at a cell's own
size, for the program and for its controls and faults, seed after seed in
one process: the readings that each limit of ``limits/<cell>.json`` is set
from (``PERF.md``). The benchmark's own runs do not run this.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \\
        --modes program,high,medium,ref_tf32,half_batch [--out FILE]

Modes: ``program`` (as the benchmark runs it); ``high`` and ``medium`` (the
program under those float32 matmul precisions); ``ref_tf32`` (the reference
in TF32, put in the program's place); and the faults of ``faults.py``. A
training cell runs its check micro-steps and one block; a serving cell one
second of its traffic. One JSON line a (mode, seed).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ref_tf32(cell, seed: int, device) -> dict:
    """The reference in TF32 against the reference in float32."""
    import torch

    from portbench import compare, loops
    from portbench import weights as W

    fam, cfg, mix = cell.family, cell.config, cell.mix
    w0 = W.make(fam.REFERENCE.param_shapes(cfg), seed, device, mix["weights"])
    if mix["loop"] == "train":
        loops.set_precision(tf32=True)
        low = loops.train_reference(cell, seed, w0, device)
        loops.set_precision(tf32=False)
        ref = loops.train_reference(cell, seed, w0, device)
        ref64 = loops.train_reference(cell, seed, w0, device, torch.float64)
        return {**compare.train_numbers(low, ref), **compare.per_f32(low, ref, ref64)}
    host = [fam.serve_request(cfg, mix, seed, r) for r in range(mix["sample"])]
    loops.set_precision(tf32=True)
    kept = {r: fam.REFERENCE.serve(w0, cfg, tuple(torch.from_numpy(a).to(device) for a in h))
            .cpu().numpy() for r, h in enumerate(host)}
    loops.set_precision(tf32=False)
    return loops.serve_reference(cell, kept, host, w0, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from egnn_tpu_torch.ops.cuda import build
    from portbench import faults, harness, loops, spec

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    build.build_all()
    cell = spec.cell(args.workload)
    seconds = 0.0 if cell.mix["loop"] == "train" else 1.0
    out = open(args.out, "a") if args.out else None
    try:
        for mode in args.modes.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                loops.set_precision(tf32=False)
                t = time.perf_counter()
                if mode == "ref_tf32":
                    numbers = ref_tf32(cell, seed, device)
                else:
                    planted = faults.planted(mode, cell.family) if mode != "program" \
                        else contextlib.nullcontext()
                    with planted:
                        result = harness.run_cell(cell, seed, seconds, False, device,
                                                  time.perf_counter(), detail=True)
                    numbers = result["numbers"]
                loops.release()
                line = json.dumps({"workload": cell.name, "mode": mode, "seed": seed,
                                   "numbers": numbers,
                                   "seconds": round(time.perf_counter() - t, 3)})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
