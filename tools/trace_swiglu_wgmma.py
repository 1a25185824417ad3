"""Variants of the prefill MoE's tensor-core body (`csrc/swiglu_wgmma.cuh`,
rows 2, 5 and 7c) timed side by side on the card.

Copies the port's `csrc/` into a scratch directory per variant (default
`chip_trace/`, which `.gitignore` lists), applies the variant's source patches
(each anchor must occur exactly once), compiles each copy's three prefill
sources (`moe_swiglu_gmm.cu`, `moe_swiglu_gmm_q4.cu`, `moe_swiglu_gmm_q8.cu`)
into a small library of its own with nvcc (all started together), and calls
their C entries on the 16B-A3B tables (64 experts of 2048 x 1408, random bf16
weights from seed 0 and their int4 and int8 quantizations) over the
expert-sorted schedule at the body's 128-row tiles, for each token count
(top-6). It prints, per variant, table
kind and token count, the device ms of the two launches (`kernel_device_ms`:
10 calls queued behind a sleep kernel) and the max abs difference of the
rows from the unpatched body's (variants that drop work are timing probes:
their rows are not the kernel's and are not checked).

    python3 tools/trace_swiglu_wgmma.py [--kinds bf16,int4,int8] [--variants base,no-fence,...]
        [--tokens 128 1152]

Variants:
    base         the body as it is
    lag1         each producer thread waits for its up copies one stage behind
    no-fence     the producer's fence.proxy.async after the up copies left
                 out (timing only)
    no-convert   int4: the packed stages not converted into B (timing only)
    no-helper    int4: the producer threads convert every packed stage alone, an
                 idle consumer warpgroup (a tile of 64 rows or fewer) not
                 converting half of it
The variants patch `swiglu_wgmma_kernel` (bf16 and int4 tables); int8 tables
take `swiglu_ra_kernel`, which only `base` times.
    stamps       %globaltimer stamps (producer thread 0, consumer thread 0):
                 one traced call is broken down per launch into the mean
                 block's microseconds: the producer's waits on the ring's
                 empty slots, its copies' issue, its waits on the packed
                 stages, its convert share, its signal (the copies' wait, the
                 fence, the arrival); the consumer's waits on full stages and
                 its products; the epilogue; and the launch's span
Variants combine with "+", e.g. lag1+no-fence or lag1+stamps (stamps last).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODY = "swiglu_wgmma.cuh"

# variant -> [(anchor, replacement)] on swiglu_wgmma.cuh
VARIANTS = {
    "base": [],
    "lag1": [("  constexpr int kLag = S - 2;", "  constexpr int kLag = 1;")],
    "no-fence": [("          cp_async_wait<kLag>();\n          fence_async_smem();\n", "          cp_async_wait<kLag>();\n"),
                 ("      cp_async_wait<0>();\n      fence_async_smem();\n", "      cp_async_wait<0>();\n")],
    "no-convert": [("  for (int i = 0; i < count; ++i) {", "  for (int i = 0; i < 0 * count; ++i) {")],
    "no-helper": [("  const bool helper = Q4 && rows <= 64;", "  const bool helper = false;")],
}
# the stamps: per block 12 values at ((launch) * 65536 + block) * 12 of a device buffer; the anchors below
_T = "        "
VARIANTS["stamps"] = [
    ("namespace {\nnamespace swg {\n",
     "namespace {\nnamespace swg {\n\n__device__ unsigned long long* g_swg_trace = nullptr;\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n  return t;\n}\n'),
    ("  const int rows = r1 - r0, n0 = blockIdx.x * kBlockCols;\n",
     "  const int rows = r1 - r0, n0 = blockIdx.x * kBlockCols;\n"
     "  unsigned long long* tr = g_swg_trace ? g_swg_trace + ((size_t)(UP ? 0 : 1) * 65536 + blockIdx.y * gridDim.x"
     " + blockIdx.x) * 12 : nullptr;\n  if (tr && threadIdx.x == 0) tr[0] = gtime();\n"),
    ("    for (int kt = 0; kt < k_tiles && (kThreadWork || pt == 0); ++kt) {\n",
     "    unsigned long long tw_e = 0, tw_i = 0, tw_p = 0, tw_c = 0, tw_s = 0;\n"
     "    if (tr && pt == 0) tr[1] = gtime();\n"
     "    for (int kt = 0; kt < k_tiles && (kThreadWork || pt == 0); ++kt) {\n"),
    ("      mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);\n",
     "      const unsigned long long t0 = gtime();\n      mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);\n"
     "      const unsigned long long t1 = gtime();\n      tw_e += t1 - t0;\n"),
    ("        cp_async_commit();\n", "        cp_async_commit();\n        tw_i += gtime() - t1;\n"),
    ("        if (kt >= kLag) {  // the stage kLag before",
     "        const unsigned long long t4 = gtime();\n        if (kt >= kLag) {  // the stage kLag before"),
    ("          mbar_arrive(full0 + 8 * ((kt - kLag) % S));\n        }\n",
     "          mbar_arrive(full0 + 8 * ((kt - kLag) % S));\n        }\n        tw_s += gtime() - t4;\n"),
    (_T + "const int ps = kt % PS;\n" + _T + "mbar_wait(pfull0 + 8 * ps, (kt / PS) & 1);\n",
     _T + "const int ps = kt % PS;\n" + _T + "const unsigned long long t2 = gtime();\n"
     + _T + "mbar_wait(pfull0 + 8 * ps, (kt / PS) & 1);\n"
     + _T + "const unsigned long long t3c = gtime();\n" + _T + "tw_p += t3c - t2;\n"),
    (_T + "else convert_stage(packed, tiles + (b - base), pt, 0, 8);\n",
     _T + "else convert_stage(packed, tiles + (b - base), pt, 0, 8);\n" + _T + "tw_c += gtime() - t3c;\n"),
    ("  } else {  // a consumer: rows 64 wgi",
     "    if (tr && pt == 0) {\n      tr[2] = tw_e, tr[3] = tw_i, tr[4] = tw_p, tr[5] = tw_c, tr[6] = tw_s;\n"
     "      tr[7] = gtime();\n    }\n  } else {  // a consumer: rows 64 wgi"),
    ("    const bool active = wgi * 64 < rows;  // else the tile's rows end in the first warpgroup's half\n",
     "    const bool active = wgi * 64 < rows;  // else the tile's rows end in the first warpgroup's half\n"
     "    unsigned long long tc_w = 0, tc_m = 0;\n"),
    ("      mbar_wait(full0 + 8 * s, (kt / S) & 1);\n",
     "      const unsigned long long t0 = gtime();\n      mbar_wait(full0 + 8 * s, (kt / S) & 1);\n"
     "      const unsigned long long t5 = gtime();\n      tc_w += t5 - t0;\n"),
    ("        fence_regs(acc);\n      }\n", "        fence_regs(acc);\n      }\n      tc_m += gtime() - t5;\n"),
    ("    if (!active) return;\n",
     "    if (tr && threadIdx.x == 0) tr[8] = tc_w, tr[9] = tc_m, tr[10] = gtime();\n    if (!active) return;\n"),
    ("  }\n}\n\n// ----", "    if (tr && threadIdx.x == 0) tr[11] = gtime();\n  }\n}\n\n// ----"),
]
# the stamps' setters, one a source (each has its own copy of the header's buffer pointer)
SETTERS = {"moe_swiglu_gmm.cu": "mu_swg_trace_set_bf16", "moe_swiglu_gmm_q4.cu": "mu_swg_trace_set_q4",
           "moe_swiglu_gmm_q8.cu": "mu_swg_trace_set_q8"}
SOURCE = {"bf16": "moe_swiglu_gmm.cu", "int4": "moe_swiglu_gmm_q4.cu", "int8": "moe_swiglu_gmm_q8.cu"}
CHECKED = {"base", "lag1", "stamps", "no-helper"}  # variants that keep the kernel's arithmetic
BODY_END = "// int8 tables (row 7c): the transposed product"  # where swiglu_wgmma_kernel's region ends


def patched_copy(out_dir: str, name: str) -> str:
    """csrc/ copied to out_dir/name with the variant's patches applied."""
    src = os.path.join(ROOT, "mingunivision_tpu_torch", "csrc")
    dst = os.path.join(out_dir, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    path = os.path.join(dst, BODY)
    text = open(path).read()
    for part in name.split("+"):
        for anchor, repl in VARIANTS[part]:
            end = text.index(BODY_END)  # swiglu_ra_kernel shares some anchors' lines: patch the region before it
            body, rest = text[:end], text[end:]
            assert body.count(anchor) == 1, (part, anchor[:60])
            text = body.replace(anchor, repl) + rest
    open(path, "w").write(text)
    if "stamps" in name.split("+"):
        for src_name, setter in SETTERS.items():
            with open(os.path.join(dst, src_name), "a") as f:
                f.write(f'\nextern "C" int {setter}(void* p) {{\n'
                        "  return (int)cudaMemcpyToSymbol(swg::g_swg_trace, &p, sizeof(p));\n}\n")
    return dst


def build_all(dirs: dict) -> dict:
    """One small library per variant (nvcc per copy, all started together)."""
    from mingunivision_tpu_torch.ops.kernels import build

    procs = {}
    for name, d in dirs.items():
        so = os.path.join(d, "libswiglu.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so, *(os.path.join(d, f) for f in SETTERS)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mu_swiglu_gmm_bf16.argtypes = [P] * 8 + [I] * 5 + [P]
        lib.mu_swiglu_gmm_q4.argtypes = [P] * 17 + [I] * 7 + [P]
        lib.mu_swiglu_gmm_q8.argtypes = [P] * 15 + [I] * 8 + [P]
        for setter in SETTERS.values():
            if hasattr(lib, setter):
                getattr(lib, setter).argtypes = [P]
        libs[name] = lib
    return libs


def report_stamps(torch, lib, call, kind: str, n: int, name: str) -> None:
    """One traced call; per launch the mean block's microseconds by part."""
    setter = getattr(lib, SETTERS[SOURCE[kind]])
    buf = torch.zeros(2 * 65536 * 12, dtype=torch.int64, device="cuda")
    assert setter(buf.data_ptr()) == 0
    call()
    torch.cuda.synchronize()
    assert setter(None) == 0
    tr = buf.view(2, 65536, 12).cpu().double()
    for launch, label in ((0, "up"), (1, "down")):
        t = tr[launch][tr[launch][:, 0] > 0]
        if not t.numel():
            continue
        us = lambda v: (v.mean() / 1e3).item()  # noqa: E731
        span = (t[:, 11].max() - t[:, 0].min()).item() / 1e3
        print(f"trace_swiglu_wgmma {kind} {n} tok {name} {label}: {t.shape[0]} blocks, span {span:.1f} us; mean "
              f"block {us(t[:, 11] - t[:, 0]):.2f} us: producer loop {us(t[:, 7] - t[:, 1]):.2f} (empty waits "
              f"{us(t[:, 2]):.2f}, issue {us(t[:, 3]):.2f}, packed waits {us(t[:, 4]):.2f}, convert {us(t[:, 5]):.2f}, "
              f"signal {us(t[:, 6]):.2f}); consumer loop {us(t[:, 10] - t[:, 0]):.2f} (full waits {us(t[:, 8]):.2f}, "
              f"products {us(t[:, 9]):.2f}); epilogue {us(t[:, 11] - t[:, 10]):.2f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="base,lag1,no-fence,no-convert,no-helper")  # see the module note
    ap.add_argument("--tokens", type=int, nargs="+", default=[128, 1152])
    ap.add_argument("--kinds", default="bf16,int4,int8", help="table kinds to time: bf16, int4, int8")
    ap.add_argument("--out", default=os.path.join(ROOT, "chip_trace"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import kernel_device_ms
    from mingunivision_tpu_torch.ops.kernels.build import check, stream_handle
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import group_schedule
    from mingunivision_tpu_torch.utils.quantize import quantize_array

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    if "base" not in names:
        names = ["base"] + names
    libs = build_all({name: patched_copy(args.out, name) for name in names})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    E, h, m, k = 64, 2048, 1408, 6
    shapes = {"gate_proj": (E, h, m), "up_proj": (E, h, m), "down_proj": (E, m, h)}
    bf = {n: torch.empty(s, device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g) for n, s in shapes.items()}
    q4 = {n: quantize_array(t, 4) for n, t in bf.items()}
    q8 = {n: quantize_array(t, 8) for n, t in bf.items()}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for n in args.tokens:
        x = torch.randn((n, h), device=dev, generator=g).to(torch.bfloat16)
        _, idx = torch.topk(torch.rand((n, E), device=dev, generator=g), k)
        _, row_token, sched = group_schedule(idx, E, 128)
        R = row_token.numel()
        hbuf = torch.empty((R, m), device=dev, dtype=torch.bfloat16)
        for kind, tables in (("bf16", bf), ("int4", q4), ("int8", q8)):
            if kind not in args.kinds.split(","):
                continue
            base = None
            for name in names:
                lib, ys = libs[name], torch.zeros((R, h), device=dev, dtype=torch.bfloat16)
                if kind == "bf16":
                    ptrs = [tables[nm].data_ptr() for nm in ("gate_proj", "up_proj", "down_proj")]

                    def call(lib=lib, ys=ys, ptrs=ptrs):
                        check(lib.mu_swiglu_gmm_bf16(x.data_ptr(), row_token.data_ptr(), *ptrs, sched.data_ptr(),
                                                     hbuf.data_ptr(), ys.data_ptr(), sched.shape[0], R, E, h, m,
                                                     stream_handle(x)), "mu_swiglu_gmm_bf16")
                elif kind == "int4":
                    ptrs = [p for nm in ("gate_proj", "up_proj", "down_proj")
                            for p in (tables[nm].q.data_ptr(), tables[nm].s.data_ptr())]

                    def call(lib=lib, ys=ys, ptrs=ptrs):
                        check(lib.mu_swiglu_gmm_q4(x.data_ptr(), row_token.data_ptr(), *ptrs, sched.data_ptr(),
                                                   hbuf.data_ptr(), ys.data_ptr(), *([0] * 6), sched.shape[0], R, E,
                                                   h, m, n, 0, stream_handle(x)), "mu_swiglu_gmm_q4")
                else:
                    ptrs = [p for nm in ("gate_proj", "up_proj", "down_proj")
                            for p in (tables[nm].q.data_ptr(), tables[nm].s.data_ptr())]

                    def call(lib=lib, ys=ys, ptrs=ptrs):
                        check(lib.mu_swiglu_gmm_q8(x.data_ptr(), row_token.data_ptr(), *ptrs, sched.data_ptr(),
                                                   hbuf.data_ptr(), ys.data_ptr(), *([0] * 4), sched.shape[0], R, E,
                                                   h, m, n, 0, 128, stream_handle(x)), "mu_swiglu_gmm_q8")
                ms = kernel_device_ms(torch, call)
                torch.cuda.synchronize()
                if "stamps" in name.split("+"):
                    report_stamps(torch, lib, call, kind, n, name)
                if name == "base":
                    base = ys.clone()
                checked = all(part in CHECKED for part in name.split("+"))
                diff = (ys.float() - base.float()).abs().max().item() if checked else None
                shown = "not checked" if diff is None else f"{diff:.3e}"
                print(f"trace_swiglu_wgmma {kind} {n} tok ({R} rows): {name:24s} device_ms="
                      f"{'not measured' if ms is None else f'{ms:.4f}'} max_abs_diff_vs_base={shown}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
