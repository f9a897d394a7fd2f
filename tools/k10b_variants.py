"""The f32 K10b's one-block instance (``pair_bwd_kernel<..., 1, kSlots>`` of
``csrc/pair_messages.cu``) in variants, on the card: copies of the source
with ``kOneBlockWgSlots`` set to each of ``--slots`` and the h-wide products
at one or five columns (``--cols``; ``bwd_kernel`` picks by ``wide_cost``
otherwise), each built by ``chip_smoke.source_libraries`` and launched
through ``build.using``. For each copy: what ptxas said of the backward's
instances (registers, spills), the f32 K10b's hashes at phase 43's four
shapes (``chip_smoke.kept_bits``; where a weight-gradient block lives and
the column blocking do not change the sums' order, so every copy must give
the same bits), K10b against its float64 plain version at anchor 5's two
shapes and phase 21's ``dim64_tile_of_8`` case, and K10b's time at anchor
5's shapes (CUDA-graph replays, the copies in turn, then in reverse),
beside a parent checkout's source and wrapper (``--parent``: the path of
its ``csrc/pair_messages.cu``; ``chip_smoke.parent_pair_messages``) and
the tensor-core mode's K10b.

Run from the root of a checkout on a machine with the card, e.g.
``python3 tools/k10b_variants.py --parent scratch/parent/egnn_tpu_torch/csrc/pair_messages.cu``.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from egnn_tpu_torch.ops.cuda import build  # noqa: E402
from egnn_tpu_torch.ops.cuda import pair_messages as PM  # noqa: E402

SOURCE = ROOT / "egnn_tpu_torch" / "csrc" / "pair_messages.cu"
SHAPES = {  # phase 43's four shapes and seeds
    "anchor3": (dict(b=1, n=CS.N, k=CS.KNN, self_pairs=True), CS.SEED + 1900),
    "anchor5_G32": (dict(b=1, n=CS.SP_G * CS.SP_NA, k=CS.SP_K, d=CS.SP_DIM, fourier=4, clamp=None,
                         gfo=True), CS.SEED + 1901),
    "anchor5_G512": (dict(b=1, n=CS.SP_G_LARGE * CS.SP_NA, k=CS.SP_K, d=CS.SP_DIM, fourier=4,
                          clamp=None, gfo=True), CS.SEED + 1902),
    "pathC": (dict(b=1, n=CS.N_A, k=CS.KNN_A, masked=False, self_pairs=True), CS.SEED + 1903),
}
SLOTS_LINE = "constexpr int kOneBlockWgSlots = "
COLS_LINE = "if (one && wide)"


def variant(text: str, slots: int, cols: int) -> str:
    """The source with ``slots`` register slots and ``cols`` h-wide columns
    in the f32 instances of one block an SM."""
    line = next(x for x in text.splitlines() if x.startswith(SLOTS_LINE))
    out = text.replace(line, f"{SLOTS_LINE}{slots};").replace(
        COLS_LINE, f"if (one && {'true' if cols == 5 else 'false'})")
    if out.count(COLS_LINE) or out.count(f"{SLOTS_LINE}{slots};") != 1:
        raise RuntimeError("the source no longer has the lines this tool edits")
    return out


def ptxas(text: str) -> list:
    """What ptxas said of the backward's instances of a copy's build."""
    digest = hashlib.sha256((text + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    log = (build.BUILD_DIR / f"copy_{digest}.log").read_text(errors="replace")
    return CS.ptxas_kernels(types.SimpleNamespace(ptxas_report=lambda name: log),
                            "pair_messages", r"pair_bwd_kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--slots", type=int, nargs="+", default=[4, 5, 6, 7])
    parser.add_argument("--cols", type=int, nargs="+", default=[1, 5], choices=[1, 5])
    parser.add_argument("--parent", default=None)
    a = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = CS.nvidia_smi_line()
    print(smi, torch.__version__, torch.version.cuda)
    src = SOURCE.read_text()
    work = ROOT / "build" / "k10b_variants"
    work.mkdir(parents=True, exist_ok=True)
    texts = {f"s{s}c{c}": variant(src, s, c) for s in a.slots for c in a.cols}
    copies = {}
    for tag, text in texts.items():
        (work / f"{tag}.cu").write_text(text)
        copies[tag] = (str(work / f"{tag}.cu"), "")
    if a.parent:
        copies["parent"] = (a.parent, "")
        texts["parent"] = Path(a.parent).read_text()
    libs = CS.source_libraries(copies)
    build._libs["pair_messages"] = libs[next(iter(texts))]   # no build of the whole package
    mods = {tag: PM for tag in libs}
    if a.parent:
        mods["parent"] = CS.parent_pair_messages(a.parent)
    for tag, text in texts.items():
        for name, regs, st, ld in ptxas(text):
            print(f"{tag} ptxas {name}: {regs} registers, spill stores {st} B, loads {ld} B")
    cases = {name: CS.pair_case(torch, seed, **kw) for name, (kw, seed) in SHAPES.items()}
    for tag, lib in libs.items():
        with build.using("pair_messages", lib):
            bits = {name: CS.kept_bits(torch, mods[tag], case)["bwd_f32"]
                    for name, case in cases.items()}
            print(f"{tag} f32 K10b bits {bits}")
            if tag != "parent":
                for name in ("anchor5_G32", "anchor5_G512"):
                    CS.check_pair_kernels(torch, PM, f"{tag} {name}", cases[name], False)
                CS.check_pair_kernels(torch, PM, f"{tag} dim64_tile_of_8", CS.pair_case(
                    torch, CS.SEED + 208, b=1, n=512, k=8, d=64), False)
    print("kept", {name: kept["bwd_f32"] for name, kept in CS.MODE_KEPT_BITS.items()})
    order = list(libs) + list(libs)[::-1]
    for name in ("anchor5_G32", "anchor5_G512"):
        case = cases[name]
        args, weights, opts = CS.pair_args(torch, PM, case, False, torch.float32)
        g = (case["g_mi"], case["g_cd"])
        times = {}
        with torch.no_grad():
            for tag in order:
                with build.using("pair_messages", libs[tag]):
                    times.setdefault(tag, []).append(CS.device_ms(
                        torch, lambda m=mods[tag]: m.fused_pair_messages_backward(
                            *args, weights, *g, opts), reps=5, trials=5))
            times["mxu_bf16"] = [CS.device_ms(torch, lambda: PM.fused_pair_messages_backward(
                *args, weights, *g, opts._replace(mxu_bf16=True)), reps=5, trials=5)]
        for tag, ms in times.items():
            print(f"{name} K10b {tag}: " + "/".join(f"{x:.5f}" for x in ms) + f" ms ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
