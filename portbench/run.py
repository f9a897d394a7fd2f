"""Run one cell of the benchmark of ``egnn_tpu_torch`` once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled window. The last
line of standard output is the result, one JSON object; the last lines of
standard error are the numbers that decided ``correct``, each beside its
limit. ``setup_s`` runs from the process's start to the window, and so
holds the nvcc build of the program's kernels in the first run of a
checkout; the result's ``build_s`` gives that build's seconds apart (a
fraction of a second once it is built). Without a card, or with fewer
cards than the cell asks for, the run
fails; it never falls back to the CPU. It fails as well where the program
is not in this checkout, and where ``jax``, ``jaxlib``, ``flax`` or
``egnn_tpu`` was loaded by the time the result is ready.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "egnn_tpu"}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(message: str, code: int = 2) -> int:
    print(f"portbench: {message}", file=sys.stderr)
    return code


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    from portbench import spec

    bench = spec.benchmark(ROOT)
    entries = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in entries:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    chips = int(entries[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} CUDA device(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    if not (ROOT / "egnn_tpu_torch" / "__init__.py").exists():
        return fail("the program (egnn_tpu_torch) is not in this checkout")
    import egnn_tpu_torch
    from egnn_tpu_torch.ops.cuda import build

    if Path(egnn_tpu_torch.__file__).resolve().parents[1] != ROOT:
        return fail(f"egnn_tpu_torch was imported from {egnn_tpu_torch.__file__}, "
                    "not from this checkout")
    from portbench import harness, loops

    cell = spec.cell(args.workload, bench)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_build = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t_build
    loops.set_precision(tf32=False)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                              T_START)
    found = forbidden_modules()
    if found:
        return fail(f"modules loaded that the port must not use: {', '.join(found)}", 3)
    result = {**{k: v for k, v in result.items() if k != "checks"}, "build_s": build_s,
              "checks": result["checks"]}
    print(f"build_s {build_s!r}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder, heads the import path
    sys.path[0] = str(ROOT)
    sys.exit(main())
