"""Measurements of the fused pair kernel K10 in its tensor-core mode
(``mxu_bf16``) on the card, beside ``chip_smoke.py``'s phase 43. Every
copy of ``csrc/pair_messages.cu`` is built by ``chip_smoke.source_libraries``
and launched through ``build.using``; the probes are the source's named probe
points (``K10_STAGE``, ``K10_TAP_*``, ``K10_MODE_TILES``), which a header
placed before the copy defines.

- ``clock SRC[@tiles=N] ...``: K10f's cycles by stage (the f32 kernel and the
  mode's), read by clock64 at ``K10_STAGE``, and each copy's time, at phase
  43's four shapes; ``@tiles=N`` builds the mode's products with warp items
  of N column tiles (``K10_MODE_TILES``) in place of one;
- ``taps``: the values that K10f in the mode and K10b's recomputation share
  (s1, m0, msg, silu(cz1), the clamped w; s1 and silu(cz1) as the forward
  reads them, rounded to bf16 where it does) read out of both kernels at
  ``K10_TAP_*`` and compared bit for bit, at phase 43's shapes and cases;
- ``reach``: the tie finder (``pair_messages.mode_tie_pairs``) at reaches of
  4x (the one phase 43 uses), 2x and 1x over phase 21's cases and the narrow
  ones: the share of live pairs each takes out and the tie-free rerun's
  ratio to phase 43's limit;
- ``rule [SRC ...]``: phase 43's rule (``chip_smoke.mode_rule``: outright,
  or on the tie-free rerun with its controls) over the same cases with the
  kernels of each SRC (a parent's source, or a copy with one rounding rule
  made wrong); this checkout's build where none is given;
- ``bwd-bits PARENT_SRC``: the mode's K10b outputs with this source and
  with a parent's, hashed, at phase 43's shapes and cases.

Run from the root of a checkout on a machine with the card, e.g.
``python3 tools/k10_mode_probe.py clock egnn_tpu_torch/csrc/pair_messages.cu``.
"""
from __future__ import annotations

import ctypes
import sys
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
STAGES = ["issue in", "weights", "wait", "unpack", "issue next", "h1", "z2", "gate", "cz1",
          "wz", "sums"]
# K10_STAGE(k): thread 0 adds the cycles since the last probe to stage k's
# count (by mode), and counts the tiles at stage 10
CLOCK = r'''
#include <cuda_runtime.h>
#define K10_PROBES 1
__device__ unsigned long long k10_clk[2][16];
__shared__ long long k10_prev;
#define K10_STAGE(k) do { if (threadIdx.x == 0) { const long long now_ = clock64(); \
  const int m_ = s.mxu_bf16 ? 1 : 0; \
  if ((k) >= 0) atomicAdd(&k10_clk[m_][(k) < 0 ? 0 : (k)], (unsigned long long)(now_ - k10_prev)); \
  if ((k) == 10) atomicAdd(&k10_clk[m_][15], 1ull); \
  k10_prev = now_; } } while (0)
#define K10_TAP_W(sub, r, w)
#define K10_TAP_FWD(s, L, mr, sm, rows, p0)
#define K10_TAP_BWD(on, s, L, sm, rows, p0)
extern "C" int probe_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(k10_clk, z, sizeof(z));
}
extern "C" int probe_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(out, k10_clk, 32 * sizeof(unsigned long long));
}
'''
# K10_TAP_*: each pair's s1 (h), m0 (m), msg (m), silu(cz1) (m4) and w, as
# the mode's forward holds them (bf16 rows where it keeps them) into
# k10_tap[0] and as the recomputation holds them (f32) into k10_tap[1]
TAPS = r'''
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#define K10_PROBES 1
#define K10_STAGE(k)
__device__ float* k10_tap[2];
__device__ float k10_tap_w[1 << 20];   // the forward's w by block and row
#define K10_TAP_W(sub, r, w) \
  do { if ((sub) == 0) k10_tap_w[blockIdx.x * 64 + (r)] = (w); } while (0)
template <class S, class Lay, class Rows>
__device__ void k10_tap_fwd(const S& s, const Lay& L, const Rows& mr, const float* sm, int rows,
                            size_t p0) {
  const int width = s.h + 2 * s.m + s.m4 + 1, ldr = L.ldr;
  const __nv_bfloat16* s1 = reinterpret_cast<const __nv_bfloat16*>(sm + mr.s1.off);
  const __nv_bfloat16* cs = reinterpret_cast<const __nv_bfloat16*>(sm + mr.cs1.off);
  for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
    const int r = e / width, j = e - r * width, q = j - s.h - 2 * s.m;
    float v;
    if (j < s.h) v = mr.s1.off >= 0 ? __bfloat162float(s1[r * mr.s1.ld + j])
                                    : sm[L.H + j * ldr + r];
    else if (j < s.h + s.m) v = sm[L.M0 + (j - s.h) * ldr + r];
    else if (q < 0) v = sm[L.MSG + (j - s.h - s.m) * ldr + r];
    else if (q < s.m4) v = mr.cs1.off >= 0 ? __bfloat162float(cs[r * mr.cs1.ld + q])
                                           : sm[L.CZ1 + q * ldr + r];
    else v = k10_tap_w[blockIdx.x * 64 + r];
    k10_tap[0][(p0 + r) * width + j] = v;
  }
  __syncthreads();
}
template <class S, class Lay>
__device__ void k10_tap_bwd(bool on, const S& s, const Lay& L, const float* sm, int rows,
                            size_t p0, const float* wcl) {
  if (!on) return;
  const int width = s.h + 2 * s.m + s.m4 + 1, ldr = L.ldr;
  for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
    const int r = e / width, j = e - r * width, q = j - s.h - 2 * s.m;
    float v;
    if (j < s.h) v = sm[L.S + j * ldr + r];
    else if (j < s.h + s.m) v = sm[L.M0 + (j - s.h) * ldr + r];
    else if (q < 0) v = sm[L.MSG + (j - s.h - s.m) * ldr + r];
    else if (q < s.m4) v = sm[L.DCZ1 + q * ldr + r];
    else v = wcl[r];
    k10_tap[1][(p0 + r) * width + j] = v;
  }
  __syncthreads();
}
#define K10_TAP_FWD(s, L, mr, sm, rows, p0) k10_tap_fwd(s, L, mr, sm, rows, p0)
#define K10_TAP_BWD(on, s, L, sm, rows, p0) \
  k10_tap_bwd(on, s, L, sm, rows, p0, (sm) + (L).ROW + WCL * (L).ldr)
extern "C" int probe_taps(float* fwd, float* rec) {
  float* p[2] = {fwd, rec};
  return (int)cudaMemcpyToSymbol(k10_tap, p, sizeof(p));
}
'''


def cases():
    """Phase 21's cases and the narrow ones, with phase 43's seeds."""
    return [(name, kw, CS.SEED + 200 + i)
            for i, (name, kw) in enumerate(CS.pair_cases() + CS.MODE_NARROW_CASES)]


def ptxas(lib_path, kernel="pair_fwd_mode_kernel"):
    """What ptxas said of ``kernel`` when it built a copy."""
    lines = Path(lib_path).with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            return f"{lines[i + 2].strip()}; {lines[i + 3].strip()}"
    return "(not in the log)"


def clock(sources):
    """Cycles a block-tile by stage and device time of each source's K10f."""
    copies = {}
    for src in sources:
        path, _, tiles = src.partition("@tiles=")
        if "K10_STAGE(" not in Path(path).read_text():
            raise SystemExit(f"{path} has no probe points (K10_STAGE)")
        copies[src] = (path, CLOCK + (f"#define K10_MODE_TILES {int(tiles)}\n" if tiles else ""))
    libs = CS.source_libraries(copies)
    print(CS.nvidia_smi_line())
    for src, lib in libs.items():
        print(f"{src}: {ptxas(lib._name)}")
        lib.probe_read.argtypes = [ctypes.c_void_p]
    for name, (kw, seed) in SHAPES.items():
        case = CS.pair_case(torch, seed, **kw)
        args, weights, opts = CS.pair_args(torch, PM, case, False, torch.float32)
        for src, lib in libs.items():
            with build.using("pair_messages", lib):
                for mode in (False, True):
                    o = opts._replace(mxu_bf16=mode)
                    fwd = lambda: PM.fused_pair_messages_forward(*args, weights, o)  # noqa: E731
                    ms = CS.device_ms(torch, fwd, reps=10, trials=5)
                    lib.probe_reset()
                    for _ in range(5):
                        fwd()
                    counts = (ctypes.c_ulonglong * 32)()
                    lib.probe_read(counts)
                    row = list(counts)[16 * mode:16 * mode + 16]
                    visits = row[15] or 1
                    stages = ", ".join(f"{stage} {row[j] / visits:.0f}"
                                       for j, stage in enumerate(STAGES))
                    print(f"{name} {src} {'mode' if mode else 'f32'}: {ms:.5f} ms; cycles a "
                          f"block-tile {sum(row[:11]) / visits:.0f}: {stages}", flush=True)
        del case, args
        torch.cuda.empty_cache()


def taps():
    """The forward's and the recomputation's shared values, bit for bit."""
    lib = CS.source_libraries({"taps": (SOURCE, TAPS)})["taps"]
    lib.probe_taps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    shapes = [(name, kw, seed) for name, (kw, seed) in SHAPES.items()] + cases()
    same = 0
    for name, kw, seed in shapes:
        case = CS.pair_case(torch, seed, **kw)
        args, weights, opts = CS.pair_args(torch, PM, case, False, torch.float32)
        b, n, k = case["idx"].shape
        h, m, m4 = weights[0].shape[1], *weights[6].shape
        width = h + 2 * m + m4 + 1
        # unwritten slots differ: the two buffers start at different values
        fwd, rec = (torch.full((b * n * k, width), v, device="cuda") for v in (1e30, -1e30))
        lib.probe_taps(fwd.data_ptr(), rec.data_ptr())
        mode = opts._replace(mxu_bf16=True)
        with build.using("pair_messages", lib), torch.no_grad():
            PM.fused_pair_messages_forward(*args, weights, mode)
            PM.fused_pair_messages_backward(*args, weights, case["g_mi"], case["g_cd"], mode)
        torch.cuda.synchronize()
        columns = {"s1": (0, h, h >= 8), "m0": (h, h + m, False),
                   "msg": (h + m, h + 2 * m, False),
                   "silu(cz1)": (h + 2 * m, width - 1, m4 >= 8), "w": (width - 1, width, False)}
        parts, equal = [], True
        for key, (lo, hi, rounded) in columns.items():
            a, r = fwd[:, lo:hi], rec[:, lo:hi]
            if rounded:   # the forward keeps them as bf16 rows
                r = r.to(torch.bfloat16).float()
            differ = int((a.view(torch.int32) != r.view(torch.int32)).sum())
            equal &= differ == 0
            parts.append(f"{key}{' (bf16)' if rounded else ''} {differ}")
        same += equal
        print(f"{name}: values that differ of {b * n * k} pairs: {', '.join(parts)}", flush=True)
        del case, args, fwd, rec
        torch.cuda.empty_cache()
    print(f"the forward and the recomputation hold the same bits at {same} of {len(shapes)}")


def reach(factors=(4.0, 2.0, 1.0)):
    """The share each reach factor takes out, and its tie-free rerun
    against phase 43's rule (this checkout's kernels)."""
    for name, kw, seed in cases():
        case = CS.pair_case(torch, seed, **kw)
        args, weights, opts = CS.pair_args(torch, PM, case, False, torch.float64)
        live = case["pv"]
        outright = {}
        CS.check_pair_kernels(torch, PM, name, case, False, mxu_bf16=True, report=outright)
        line = [f"{name}: outright {outright['ratio']:.3f} ({outright['tensor']})"]
        for factor in factors:
            rounding, clamp = PM.mode_tie_pairs(*args, weights, case["g_mi"], case["g_cd"], opts,
                                                factor=factor)
            ties = rounding | clamp
            rerun = {}
            CS.check_pair_kernels(torch, PM, name, dict(case, pv=live & ~ties), False,
                                  mxu_bf16=True, report=rerun)
            fail = " FAIL" if rerun["failed"] else ""
            line.append(f"{factor:g}x: {int(ties.sum()) / int(live.sum()):.2%} -> "
                        f"{rerun['ratio']:.3f} ({rerun['tensor']}){fail}")
        print("; ".join(line), flush=True)
        del case
        torch.cuda.empty_cache()


def rule_over_cases():
    """``chip_smoke.mode_rule`` over the cases with the kernels now loaded:
    the names of the cases that fail it."""
    failed = []
    for name, kw, seed in cases():
        r = CS.mode_rule(torch, PM, name, CS.pair_case(torch, seed, **kw))
        line = (f"{name}: outright {r['outright']['ratio']:.3f} of the limit "
                f"({r['outright']['tensor']}); tie-free {r['rerun']['ratio']:.3f} "
                f"({r['rerun']['tensor']}) without {r['share']:.2%} of the pairs")
        if r["controls"]:
            line += "; controls, as many other pairs out: " + ", ".join(
                f"{c['ratio']:.3f} ({c['tensor']})" for c in r["controls"])
        print(f"{line}; passed: {r['passed']}", flush=True)
        if r["passed"] == "no":
            failed.append(name)
        del r
        torch.cuda.empty_cache()
    return failed


def rule(sources):
    """Phase 43's rule with the kernels of each source."""
    libs = (CS.source_libraries({src: (src, "") for src in sources}) if sources
            else {"this checkout's build": build.library("pair_messages")})
    for src, lib in libs.items():
        with build.using("pair_messages", lib):
            print(f"== {src}", flush=True)
            failed = rule_over_cases()
        print(f"{src}: phase 43's rule fails at {len(failed)} of {len(cases())} cases: {failed}",
              flush=True)


def bwd_bits(parent):
    """The mode's K10b with this source and the parent's, hashed."""
    libs = {"this": build.library("pair_messages"),
            "parent": CS.source_libraries({"parent": (parent, "")})["parent"]}
    shapes = [(name, kw, seed) for name, (kw, seed) in SHAPES.items()] + cases()
    equal = 0
    for name, kw, seed in shapes:
        case = CS.pair_case(torch, seed, **kw)
        args, weights, opts = CS.pair_args(torch, PM, case, False, torch.float32)
        digest = {}
        for tag, lib in libs.items():
            with build.using("pair_messages", lib), torch.no_grad():
                d_ci, d_cj, d_fj, d_pi, d_w = PM.fused_pair_messages_backward(
                    *args, weights, case["g_mi"], case["g_cd"], opts._replace(mxu_bf16=True))
            digest[tag] = CS.bits_digest([d_ci, d_cj, d_fj, d_pi, *d_w])
        equal += digest["this"] == digest["parent"]
        print(f"{name}: this {digest['this']}, parent {digest['parent']}", flush=True)
        del case, args
        torch.cuda.empty_cache()
    print(f"the mode's K10b gives the parent's bits at {equal} of {len(shapes)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("k10_mode_probe: this needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    command, rest = sys.argv[1], sys.argv[2:]
    if command == "clock":
        clock(rest)
    elif command == "taps":
        taps()
    elif command == "reach":
        reach()
    elif command == "rule":
        rule(rest)
    elif command == "bwd-bits":
        bwd_bits(rest[0])
    else:
        raise SystemExit(f"unknown command {command!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
