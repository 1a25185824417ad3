"""Phase trace of the fused RF samplers (`csrc/rf_sampler_q4.cu`, and with
--bits 8 `csrc/rf_sampler_q8.cu`, their shared body) on the card.

Copies `mingunivision_tpu_torch/` into a scratch directory (default
`chip_trace/`, which `.gitignore` lists), adds `%globaltimer` stamps at the
consumer warps' phase boundaries (thread 0 of each CTA, per block), builds that
copy and runs the sampler at the 16B-A3B width (the kernels phase's head:
random weights from seed 0, AdaLN at std 0.02) at the given CFG rows. It prints
the kernel's device time (CUDA events, 5 calls) and, from one traced call, the
mean over CTAs and blocks of each phase in microseconds:

    x      x into shared memory, the modulated LN, x's operands (int4: its s8
           pair; int8: its digits, or with --s8 its s8 values)
           (split: x load, row statistics, modulated LN with the row maxima,
           the operands)
    up     the up units (split: to the last stage consumed, the last tile's
           flush and ticket, the rest: the tile epilogue where last)
    bar1   the first grid barrier
    hq     h's operands of the CTA's down stages
    down   the down units (split as up)
    bar2   the second grid barrier
and the step epilogue (final layer, CFG, Euler update, input_proj) per step.
With --no-stream the producer issues nothing and the consumers do not wait for
the ring (the products run on whatever shared memory holds): the time the
kernel takes without its weight stream. The copy's results are not the
kernel's in that mode and are not checked.

    python3 tools/trace_rf_sampler_q4.py --rows 2 3 [--no-stream] [--bits 8 [--s8]]
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "mingunivision_tpu_torch/csrc/rf_sampler_q4.cu"
TR = 24  # stamps a block

# (anchor in the kernel source, what replaces it): every anchor must occur exactly once
PATCHES = [
    ("namespace {\n\nusing namespace rf;\n",
     "__device__ unsigned long long* g_trace = nullptr;\n"
     "__device__ int g_no_stream = 0;\n"
     'extern "C" int mu_rf_trace_set(void* p, int no_stream) {\n'
     "  cudaError_t e = cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n"
     "  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(g_no_stream, &no_stream, sizeof(int)));\n"
     "}\n\nnamespace {\n\nusing namespace rf;\n\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n"),
    ("    if (lane == 0) {\n      // stage k of the sequence",
     "    if (lane == 0 && !g_no_stream) {\n      // stage k of the sequence"),
    ("    wait_phase(full0 + 8 * slot, phase);\n",
     "    if (!g_no_stream) wait_phase(full0 + 8 * slot, phase);\n"),
    ("    if (lane == 0) mbar_arrive(empty0 + 8 * slot);\n",
     "    if (lane == 0 && !g_no_stream) mbar_arrive(empty0 + 8 * slot);\n"),
    ("      const int b = s * L + l, par = b & 1;\n",
     "      const int b = s * L + l, par = b & 1;\n"
     f"      unsigned long long* tr = g_trace ? g_trace + ((size_t)cta * S * L + b) * {TR} : nullptr;\n"
     "      auto stamp = [&](int k) { if (tr && tid == 0) tr[k] = gtime(); };\n"
     "      stamp(0);\n"),
    ("      row_stats<R, ConsumerSync>(xs, w, a.ln_eps, stats, fscr);\n      // a thread per 4 columns",
     "      stamp(12);\n      row_stats<R, ConsumerSync>(xs, w, a.ln_eps, stats, fscr);\n      stamp(14);\n"
     "      // a thread per 4 columns"),
    ("        block_allreduce<2 * R>(mx, fscr, MaxOp<float>(), ConsumerSync());\n",
     "        block_allreduce<2 * R>(mx, fscr, MaxOp<float>(), ConsumerSync());\n        stamp(15);\n"),
    ("      // up units: gate / up columns",
     "      stamp(1);\n      // up units: gate / up columns"),
    ("        if (ks < KTu - 1 && u < u1 - 1) continue;\n",
     "        if (ks < KTu - 1 && u < u1 - 1) continue;\n        if (u == u1 - 1) stamp(19);\n"),
    ("        if (!take_ticket(ws.tickets + tile, u - max(u0, tile * KTu) + 1, KTu, flag)) continue;\n",
     "        const bool last_up = take_ticket(ws.tickets + tile, u - max(u0, tile * KTu) + 1, KTu, flag);\n"
     "        if (u == u1 - 1) stamp(20);\n        if (!last_up) continue;\n"),
    ("      grid_barrier(ws.bar, ++barriers * G);\n\n      // h: the s8 pair",
     "      stamp(2);\n      grid_barrier(ws.bar, ++barriers * G);\n      stamp(3);\n\n      // h: the s8 pair"),
    ("      // down units: the residual",
     "      stamp(4);\n      // down units: the residual"),
    ("        if (!take_ticket(ws.tickets + Tu + tile, k - kf + 1, KTd, flag)) continue;\n",
     "        if (u == d1 - 1) stamp(16);\n"
     "        const bool last_down = take_ticket(ws.tickets + Tu + tile, k - kf + 1, KTd, flag);\n"
     "        if (u == d1 - 1) stamp(17);\n        if (!last_down) continue;\n"),
    ("      grid_barrier(ws.bar, ++barriers * G);\n      if (cta == 0) {",
     "      stamp(5);\n      grid_barrier(ws.bar, ++barriers * G);\n      stamp(6);\n      if (cta == 0) {"),
    ("    guide_step<R, ConsumerSync>(a, s, lat, vel);\n  }\n",
     "    guide_step<R, ConsumerSync>(a, s, lat, vel);\n"
     f"    if (g_trace && tid == 0) g_trace[((size_t)cta * S * L + s * L + L - 1) * {TR} + 10] = gtime();\n  }}\n"),
]
# the int8 sampler's source: the same body, but for these anchors (int4 anchor -> the text that differs in it and
# in its replacement, and the int8 source's text)
SOURCE_Q8 = "mingunivision_tpu_torch/csrc/rf_sampler_q8.cu"
Q8_ANCHORS = {
    "        block_allreduce<2 * R>(mx, fscr, MaxOp<float>(), ConsumerSync());\n": ("<2 * R>", "<R>"),
    "      grid_barrier(ws.bar, ++barriers * G);\n\n      // h: the s8 pair": ("the s8 pair", "the operands"),
    "      grid_barrier(ws.bar, ++barriers * G);\n      if (cta == 0) {": ("if (cta == 0) {", "if (cta == 0) "),
}
BUILD = "mingunivision_tpu_torch/ops/kernels/build.py"
BUILD_PATCH = ('    "mu_rf_sampler_q4s8_workspace": [_I] * 3,\n',
               '    "mu_rf_sampler_q4s8_workspace": [_I] * 3,\n    "mu_rf_trace_set": [_P, _I],\n')


def patches(bits: int = 4):
    """(anchor, replacement) pairs for the int4 or int8 sampler's source."""
    if bits == 4:
        return PATCHES
    out = []
    for anchor, new in PATCHES:
        four, eight = Q8_ANCHORS.get(anchor, ("", ""))
        out.append((anchor.replace(four, eight), new.replace(four, eight)) if four else (anchor, new))
    return out


def patched(source: str, bits: int = 4) -> str:
    """The kernel source with the stamps (each anchor replaced once; a missing or repeated anchor raises)."""
    for anchor, new in patches(bits):
        if source.count(anchor) != 1:
            raise ValueError(f"anchor found {source.count(anchor)} times: {anchor[:60]!r}")
        source = source.replace(anchor, new)
    return source


def make_copy(dest: str, bits: int = 4) -> None:
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "mingunivision_tpu_torch"), os.path.join(dest, "mingunivision_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    source = SOURCE if bits == 4 else SOURCE_Q8
    for rel, fn in ((source, lambda s: patched(s, bits)), (BUILD, lambda s: s.replace(*BUILD_PATCH))):
        path = os.path.join(dest, rel)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(fn(text))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[2])
    ap.add_argument("--no-stream", action="store_true")
    ap.add_argument("--bits", type=int, choices=(4, 8), default=4)
    ap.add_argument("--s8", action="store_true", help="the int8 sampler's s8 dots (default: its exact digit dots)")
    ap.add_argument("--dir", default=os.path.join(ROOT, "chip_trace"))
    args = ap.parse_args(argv)
    make_copy(args.dir, args.bits)
    sys.path.insert(0, args.dir)
    import torch

    from mingunivision_tpu_torch.config import MingUniVisionConfig
    from mingunivision_tpu_torch.models.rf_head import _time_grid, precompute_modulations
    from mingunivision_tpu_torch.ops.kernels import build
    from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs
    from mingunivision_tpu_torch.utils.convert import _Init, init_rf_head_params
    from mingunivision_tpu_torch.utils.quantize import quantize_tree_inplace

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = MingUniVisionConfig().rf_head
    g = torch.Generator(device=dev).manual_seed(0)
    rf = init_rf_head_params(cfg, _Init(dev, torch.bfloat16, g))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.02, generator=g)
    quantize_tree_inplace(rf, bits=args.bits)
    ts, dts = _time_grid(cfg, None, device=dev)
    S, L = cfg.num_sampling_steps, cfg.depth
    lib = build.load()
    G = lib.mu_rf_sampler_grid()
    print(f"{torch.cuda.get_device_name(0)}; int{args.bits}{' s8 dots' if args.s8 else ''} sampler; grid {G}; the "
          f"stream {'off' if args.no_stream else 'on'}")
    for rows in args.rows:
        z = torch.randn((rows, cfg.z_channels), device=dev, generator=g).to(torch.bfloat16)
        bm, fm = precompute_modulations(rf, cfg, ts, z)
        noise = torch.randn((1, cfg.target_channels), device=dev, generator=g).repeat(rows, 1)
        call = lambda: rs.rf_sample_fused(rf, cfg, noise, bm, fm, dts, 3.0, 1.1, cfg_rows=rows,  # noqa: E731,B023
                                          renorm_channel=rows == 3, s8_dots=args.s8)
        build.check(lib.mu_rf_trace_set(None, int(args.no_stream)), "trace")
        for _ in range(3):
            call()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            call()
        e1.record()
        e1.synchronize()
        buf = torch.zeros((G, S * L, TR), dtype=torch.int64, device=dev)
        build.check(lib.mu_rf_trace_set(buf.data_ptr(), int(args.no_stream)), "trace")
        call()
        torch.cuda.synchronize()
        build.check(lib.mu_rf_trace_set(None, 0), "trace")
        tr = buf.cpu().double()

        def span(a, b, later_blocks_only=False):  # mean us from stamp a to stamp b, CTAs that set both
            out = []
            for blk in range(1, S * L):
                if later_blocks_only and blk % L == 0:  # a step's first block has no x load
                    continue
                m = (tr[:, blk, a] > 0) & (tr[:, blk, b] > 0)
                if m.any():
                    out.append(((tr[:, blk, b] - tr[:, blk, a])[m] / 1e3).mean().item())
            return statistics.mean(out)

        step = [(tr[:, blk, 6].max() - tr[:, blk - 1, 6].max()).item() / 1e3 for blk in range(1, S * L)]
        epi = statistics.mean([(tr[:, (s + 1) * L, 0] - tr[:, s * L + L - 1, 6]).mean().item() / 1e3
                               for s in range(S - 1)])
        print(f"rows {rows}: {e0.elapsed_time(e1) / 5:.3f} ms a call (CUDA events, 5 calls); block step "
              f"{statistics.mean(step):.2f} us (slowest CTA to slowest CTA)")
        print("  phases, us: " + ", ".join(f"{n} {span(a, b):.2f}" for n, (a, b) in {
            "x": (0, 1), "up": (1, 2), "bar1": (2, 3), "hq": (3, 4), "down": (4, 5), "bar2": (5, 6)}.items()))
        print(f"  x: load {span(0, 12, True):.2f}, row stats {span(12, 14, True):.2f}, modulated LN + maxima "
              f"{span(14, 15, True):.2f}, operands {span(15, 1, True):.2f}; up: stages {span(1, 19):.2f}, last "
              f"flush + ticket {span(19, 20):.2f}, rest {span(20, 2):.2f}; down: stages {span(4, 16):.2f}, last "
              f"flush + ticket {span(16, 17):.2f}, rest {span(17, 5):.2f}; step epilogue + input_proj {epi:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
