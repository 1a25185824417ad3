#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mingunivision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure exits non-zero:
  1. device   card name and power limit (nvidia-smi); TF32 off
  2. build    nvcc-builds the kernels under mingunivision_tpu_torch/csrc (one
              nvcc per source, all started together)
  3. kernels  each CUDA kernel against its plain PyTorch version on the same
              inputs, at the main paths' shapes: max abs error, error relative
              to max |plain|, median CUDA-event times of both (and of the one
              PyTorch call that computes the same function, where there is
              one), and the least time the card could take (bound); the
              prefill MoE kernels also through the capacity-dense dispatch at
              the understanding prompt's 1,152 tokens, beside the expert-sorted one
  4. reference  a small model on the card, bf16 and then int4, through the
              kernels (bf16 compute) against the plain versions in fp32: same
              tokens; the step-0 hidden state and first RF latent within
              twice the plain bf16 path's own error (+1e-2 of their maximum);
              the image of the right shape, finite, in [-1, 1]. Then the same
              on an image prompt that pads to 512 tokens (flash prefill, the
              capacity dispatch, text decode): same tokens, the prefill's
              last-position hidden state within the same bound
  5. slice    single-image text-to-image through MingUniVisionSession.generate
              at the full 16B-A3B width (random weights from a seed, bf16,
              max_seq_len 4096): output checks, launch counts of every kernel,
              prefill / image-loop / pixel-decode times, peak memory
  6. slice_int4  the same round with the LLM and RF head quantized to the
              int4 tier on the card (the serving tier): the int4 kernels'
              launch counts, times, resident and peak memory
  7. understand  image -> text on each tier's full-width model: a 1024-px image
              (1,024 patch tokens, the prompt pads to 1,152) through the
              MingTok encoder, flash prefill and the capacity MoE dispatch
              (the random model's attention outputs damped first, or every
              image row would route to the same experts and overflow it), then
              32 greedy text tokens; launch counts, capacity fallbacks, encode
              / prefill / per-text-token times, peak memory
  8. edit     image + edit request -> image on each tier's model: a 512-px image
              (256 patch tokens, the prompt pads to 384), the 256-token image
              loop with 3 CFG rows; launch counts, ms per AR token
  9. recon    MingTok reconstruction (encode -> pixel decode) at 512 px, batch
              1 and 8, on the pixel decoder's "high", "default" and "bf16"
              tiers: flash-ViT launches, PSNR of the reduced tiers against
              "high", ms per image
A tier's model is built once and serves its slice, understand and edit phases.
Then a JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--phases` picks the phases (default: the nine above), e.g.
`--phases device,build,kernels,understand`. Five more run only when named:
  divergence  the small model's plain bf16 path with each kernel swapped in
              alone, and all three, against plain bf16 and fp32: semantic-token
              error at loop step 0 and over the loop, image error
  profile     the slice with a 16-token image loop under torch.profiler:
              device ms per stage, device busy share, device events per token,
              top kernels; then the same round unprofiled (`--tier int4` for
              the int4 slice)
  profile_understand  the understanding round with 8 text tokens under
              torch.profiler: device ms of the encode, prefill and text-decode
              stages, busy share, top kernels (`--tier`)
  routing     the understanding prompt's expert loads per layer on the
              full-width random model (`--tier`), as initialised and with the
              attention outputs damped, against the capacity of the dispatch
  rf_sensitivity  the int4 RF sampler at full width: the kernel against its
              plain version beside the plain version against itself under a
              1-ulp change of its input, over 1 and 12 blocks and 1 and 16
              steps; first, how often a CUDA division by a Python number
              misses the correctly rounded quotient
e.g. `python3 chip_smoke.py --phases device,build,divergence,profile`.
The nvcc/ptxas log (registers, shared memory, spills) lands beside the built
library, under mingunivision_tpu_torch/_build/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# kernel -> (its source, the TPU kernel it replaces: file:line of the Pallas kernel body)
KERNELS = {
    "moe_stream": ("csrc/moe_stream.cu", "mingunivision_tpu/ops/kernels/moe_stream.py:51"),
    "moe_swiglu_gmm": ("csrc/moe_swiglu_gmm.cu", "mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py:70"),
    "decode_attention": ("csrc/decode_attention.cu", "mingunivision_tpu/ops/kernels/decode_attention.py:38"),
    "moe_stream_q4s8": ("csrc/moe_stream_q4.cu", "mingunivision_tpu/ops/kernels/moe_stream.py:179"),
    "moe_swiglu_gmm_q4": ("csrc/moe_swiglu_gmm_q4.cu", "mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py:356"),
    "rf_sampler_q4s8": ("csrc/rf_sampler_q4.cu", "mingunivision_tpu/ops/kernels/rf_sampler.py:272"),
    "flash_prefill": ("csrc/flash_attention.cu", "mingunivision_tpu/ops/kernels/flash.py:31"),
    "flash_vit": ("csrc/flash_attention.cu", "mingunivision_tpu/ops/kernels/flash.py:63"),
}
BF16_KERNELS = ("moe_stream", "moe_swiglu_gmm", "decode_attention")
REL_TOL = 1e-2  # kernel vs plain: max |err| <= REL_TOL * max |plain| (bf16 keeps ~3 digits)
# H100 SXM data sheet: HBM3 bytes/s and dense peak operations/s by operand type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12}


def fail(msg: str) -> int:
    print(f"FAIL {msg}", file=sys.stderr)
    return 1


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn` over `iters` CUDA-event timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and err <= REL_TOL * scale + 1e-6
    return ok, err, err / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def bound(nbytes: float, ops: float, kind: str):
    """The least time the card could take (ms) and what sets it: the bytes the
    function must move over the memory rate, or its operations over the peak
    rate of their type, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_case(torch, results, name, label, kern, plain, nbytes, ops, kind, library=None, iters=20, rows=None,
             others=None) -> bool:
    """One kernel case: the kernel against its plain version on the same inputs
    (on the rows of the boolean mask `rows` when given), their median times
    (and the library call's), and the bound. `others`: label -> a callable timed
    beside them and recorded in the case under `<label>_ms`."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    ok, err, rel = compare(torch, got, want) if rows is None else compare(torch, got[rows], want[rows])
    ms, plain_ms = cuda_ms(torch, kern, iters), cuda_ms(torch, plain, iters)
    library_ms = cuda_ms(torch, library, iters) if library is not None else None
    other_ms = {f"{key}_ms": cuda_ms(torch, fn, iters) for key, fn in (others or {}).items()}
    bound_ms, bound_by = bound(nbytes, ops, kind)
    lib = f" library_ms={library_ms:.4f}" if library_ms is not None else ""
    lib += "".join(f" {key}={val:.4f}" for key, val in other_ms.items())
    print(f"kernel {name} [{label}]: max_abs_err={err:.3e} rel_to_max={rel:.3e} tol_rel={REL_TOL} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}{lib} bound_ms={bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} G{'FLOP' if kind == 'bf16' else 'OP ' + kind}) {'ok' if ok else 'MISMATCH'}")
    results.setdefault(name, {}).setdefault("cases", []).append(
        {"shape": label, "max_abs_err": err, "rel_to_max": rel, "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by, **other_ms})
    return ok


def moe_cases(torch, g, E, k):
    """(label, tokens, experts the routing may pick) of the MoE kernel cases."""
    def routing(n, choices=None):
        scores = torch.rand((n, E), device="cuda", generator=g)
        if choices is not None:  # skewed: only these experts are ever routed
            allowed = torch.zeros(E, dtype=torch.bool, device="cuda")
            allowed[choices] = True
            scores = scores.masked_fill(~allowed, -1.0)
        w, idx = torch.topk(torch.softmax(scores, -1), k)
        return idx, (w / w.sum(-1, keepdim=True)).to(torch.bfloat16)
    decode = [("N=2 k=6 (slice decode)", 2, None), ("N=16 k=6 (A>E dedup)", 16, None)]
    prefill = [("128 tok x k=6 (slice prefill)", 128, None),
               ("128 tok x k=6 skewed to 8 experts", 128, [0, 5, 9, 17, 33, 34, 50, 63])]
    return routing, decode, prefill


def full_width_rf(torch, rf_cfg, generator, adaln_std: float):
    """The RF head at `rf_cfg`'s width on the card: random bf16 weights, the
    AdaLN and final layers drawn at `adaln_std`, quantized to int4 in place."""
    from mingunivision_tpu_torch.utils.convert import _Init, init_rf_head_params
    from mingunivision_tpu_torch.utils.quantize import quantize_tree_inplace

    rf = init_rf_head_params(rf_cfg, _Init(torch.device("cuda"), torch.bfloat16, generator))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, adaln_std, generator=generator)
    return quantize_tree_inplace(rf, bits=4)


def run_rf_sensitivity(torch) -> bool:
    """How far the int4 RF sampler's output moves under a 1-ulp change, against
    how far the kernel lies from its plain version (after a count of how often
    PyTorch's CUDA division misses the correctly rounded quotient, the 1-ulp
    change the plain version once made): full width, 2 CFG rows, one
    block or all 12, one Euler step or all 16, AdaLN weights at std 0.02 (the
    slice's) and 0.002. The ulp change multiplies every modulated-LN output of
    the plain version by 1 +- 2**-22 before its s8 quantization."""
    from mingunivision_tpu_torch.config import MingUniVisionConfig
    from mingunivision_tpu_torch.models.rf_head import _time_grid, precompute_modulations
    from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs

    dev = torch.device("cuda")
    rf_cfg = MingUniVisionConfig().rf_head
    exact_ln = rs._modulated_ln

    def ulp_ln(*args, **kwargs):
        y = exact_ln(*args, **kwargs)
        sign = torch.randint(0, 2, y.shape, device=y.device, generator=torch.Generator(device=y.device).manual_seed(1))
        return y * (1 + (2 * sign - 1) * 2.0**-22)

    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
    # why the plain versions divide by a device tensor (intdot.div_exact): PyTorch's CUDA division by a
    # Python number multiplies by the rounded reciprocal
    x = torch.randn(4_000_000, device=dev, generator=torch.Generator(device=dev).manual_seed(5)) * 30
    for d in (3072.0, 127.0):
        exact = (x.double() / d).float()
        print(f"rf_sensitivity [x / {d:g} on the card, 4e6 normal fp32 x]: not correctly rounded by a Python "
              f"number {int((x / d != exact).sum())}, by a device tensor "
              f"{int((x / torch.full((), d, device=dev) != exact).sum())}")
    ok = True
    for std in (0.02, 0.002):
        g = torch.Generator(device=dev).manual_seed(0)
        rf = full_width_rf(torch, rf_cfg, g, std)
        ts, dts = _time_grid(rf_cfg, None, device=dev)
        z = torch.randn((2, rf_cfg.z_channels), device=dev, generator=g).to(torch.bfloat16)
        block_mods, final_mods = precompute_modulations(rf, rf_cfg, ts, z)
        noise = torch.randn((1, rf_cfg.target_channels), device=dev, generator=g).repeat(2, 1)
        first = {"in_ln": {k: v[:1] for k, v in rf["res_blocks"]["in_ln"].items()},
                 "mlp": {k: {"w": v["w"][:1], "b": v["b"][:1]} for k, v in rf["res_blocks"]["mlp"].items()}}
        for L, params in ((1, {**rf, "res_blocks": first}), (rf_cfg.depth, rf)):
            for S in (1, rf_cfg.num_sampling_steps):
                args = (params, rf_cfg, noise, block_mods[:L, :S], final_mods[:S], dts[:S], 3.0, 1.1)
                kw = dict(cfg_rows=2, renorm_channel=False, compute_dtype=torch.bfloat16)
                kernel, plain = rs.rf_sample_fused(*args, **kw), rs.rf_sample_fused_plain(*args, **kw)
                rs._modulated_ln = ulp_ln
                try:
                    perturbed = rs.rf_sample_fused_plain(*args, **kw)
                finally:
                    rs._modulated_ln = exact_ln
                ok &= bool(torch.isfinite(kernel).all())
                print(f"rf_sensitivity [AdaLN std {std}, {L} block(s), {S} step(s)]: max|plain|="
                      f"{plain.abs().max().item():.3f} kernel vs plain {rel(kernel, plain):.3e}; "
                      f"1-ulp-perturbed plain vs plain {rel(perturbed, plain):.3e}")
        del rf
    return ok


def check_kernels(torch, results: dict) -> bool:
    """Every kernel against its plain version at the main paths' shapes (the
    16B-A3B LLM's expert tables, the 2-row CFG decode attention over the 4096
    cache, the RF head at full width over 16 Euler steps)."""
    from mingunivision_tpu_torch.config import MingUniVisionConfig
    from mingunivision_tpu_torch.models.rf_head import _time_grid, precompute_modulations
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.flash import (
        flash_prefill_attention,
        flash_prefill_attention_plain,
        flash_vit_attention,
        flash_vit_attention_plain,
    )
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import (
        default_capacity,
        moe_experts_capacity_gmm,
        moe_experts_capacity_gmm_exact,
        moe_experts_capacity_gmm_exact_plain,
    )
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_plain, moe_experts_stream
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_plain
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused, rf_sample_fused_plain
    from mingunivision_tpu_torch.utils.quantize import quantize_array

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    cfg = MingUniVisionConfig()
    E, h, m, k = cfg.llm.num_experts, cfg.llm.hidden_size, cfg.llm.moe_intermediate_size, cfg.llm.num_experts_per_tok
    shapes = {"gate_proj": (1, E, h, m), "up_proj": (1, E, h, m), "down_proj": (1, E, m, h)}
    experts = {n: torch.empty(sh, device=dev, dtype=bf).normal_(0, 0.02, generator=g) for n, sh in shapes.items()}
    routing, decode, prefill = moe_cases(torch, g, E, k)
    all_ok = True

    def moe_work(idx, n, tables_bytes_per_expert, act_bytes):
        unique = int(torch.unique(idx).numel())
        return unique * tables_bytes_per_expert + 2 * n * h * act_bytes, 6.0 * idx.numel() * h * m

    # the understanding prompt: 1,060 valid rows and 92 padding rows (one shared embedding, one routing)
    n_und, n_pad = 1152, 92
    cap = default_capacity(n_und, k, E, cfg.llm.moe_prefill_capacity_factor)
    und_valid = torch.arange(n_und, device=dev) < n_und - n_pad

    def capacity_cases(tables, name, per_expert_bytes):
        """Kernel `name` launched through the capacity-dense dispatch at the
        understanding prompt's shape, beside the expert-sorted dispatch on the
        same routing: a natural routing (it fits the slots; padding rows kept
        out by token_valid) and one skewed to 8 experts (it overflows, and the
        sorted dispatch runs: a counted fallback). Valid rows are compared."""
        ok = True
        for label, choices, fits in ((f"capacity dispatch C={cap}: 1152 tok (92 pads) x k=6", None, True),
                                     ("capacity dispatch, skewed to 8 experts: overflow -> sorted fallback",
                                      [0, 5, 9, 17, 33, 34, 50, 63], False)):
            x = torch.randn((n_und, h), device=dev, generator=g).to(bf)
            idx, w = routing(n_und, choices)
            x[~und_valid], idx[~und_valid], w[~und_valid] = x[-1].clone(), idx[-1].clone(), w[-1].clone()
            launches, fallbacks = moe_experts_capacity_gmm.launches, moe_experts_capacity_gmm_exact.fallbacks
            args = (tables, x, idx, w, E, cap)
            kw = dict(token_valid=und_valid, layer_idx=0)
            nbytes, ops = moe_work(idx[und_valid], n_und, per_expert_bytes, 2)
            ok &= run_case(torch, results, name, label, lambda: moe_experts_capacity_gmm_exact(*args, **kw),  # noqa: B023
                           lambda: moe_experts_capacity_gmm_exact_plain(*args, **kw), nbytes, ops, "bf16",  # noqa: B023
                           iters=5, rows=und_valid,
                           others={"sorted_dispatch": lambda: moe_experts_swiglu_gmm(*args[:5], layer_idx=0)})  # noqa: B023
            went = (moe_experts_capacity_gmm.launches > launches, moe_experts_capacity_gmm_exact.fallbacks > fallbacks)
            print(f"kernel {name} [{label}]: through the slots={went[0]} fell back={went[1]}")
            ok &= went == (fits, not fits)
            results[name]["cases"][-1].update(capacity=cap, fell_back=went[1])
        return ok

    # bf16 tables: 3 h m bf16 per routed expert
    for kernel, plain_fn, cases, name in ((moe_experts_stream, moe_experts_stream_plain, decode, "moe_stream"),
                                          (moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_plain, prefill,
                                           "moe_swiglu_gmm")):
        for label, n, choices in cases:
            x = torch.randn((n, h), device=dev, generator=g).to(bf)
            idx, w = routing(n, choices)
            extra = (E,) if name == "moe_swiglu_gmm" else ()
            nbytes, ops = moe_work(idx, n, 3 * h * m * 2, 2)
            all_ok &= run_case(torch, results, name, label,
                               lambda: kernel(experts, x, idx, w, *extra, layer_idx=0),  # noqa: B023
                               lambda: plain_fn(experts, x, idx, w, *extra, layer_idx=0),  # noqa: B023
                               nbytes, ops, "bf16")
    all_ok &= capacity_cases(experts, "moe_swiglu_gmm", 3 * h * m * 2)

    # int4 tables of the same weights: 3 h m / 2 bytes and 2 m + h fp32 scales per routed expert
    q4 = {n: quantize_array(t, 4) for n, t in experts.items()}
    del experts
    torch.cuda.empty_cache()
    per_expert = 3 * h * m // 2 + (2 * m + h) * 4
    for kernel, plain_fn, cases, name, kind in (
            (moe_experts_stream, moe_experts_stream_plain, decode, "moe_stream_q4s8", "int8"),
            (moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_plain, prefill, "moe_swiglu_gmm_q4", "bf16")):
        for label, n, choices in cases:
            x = torch.randn((n, h), device=dev, generator=g).to(bf)
            idx, w = routing(n, choices)
            extra = (E,) if name == "moe_swiglu_gmm_q4" else ()
            nbytes, ops = moe_work(idx, n, per_expert, 2)
            all_ok &= run_case(torch, results, name, label,
                               lambda: kernel(q4, x, idx, w, *extra, layer_idx=0),  # noqa: B023
                               lambda: plain_fn(q4, x, idx, w, *extra, layer_idx=0),  # noqa: B023
                               nbytes, ops, kind)
    all_ok &= capacity_cases(q4, "moe_swiglu_gmm_q4", per_expert)
    del q4

    B, Hq, Hkv, S, D = 2, cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads, 4096, cfg.llm.head_dim
    q = torch.randn((B, 1, Hq, D), device=dev, generator=g).to(bf)
    kc = torch.randn((B, Hkv, S, D), device=dev, generator=g).to(bf)
    vc = torch.randn((B, Hkv, S, D), device=dev, generator=g).to(bf)
    mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
    mask[0, :700] = True
    mask[1, :321] = True
    mask[1, 400:450] = True  # CFG-style hole
    mask[1, 3000:3001] = True  # an isolated allowed position in a late tile
    allowed = int(mask.sum())
    nbytes = allowed * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2 + B * S  # K and V where allowed, q, out, mask
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), kc, vc, attn_mask=mask[:, None, None, :], enable_gqa=True)
    all_ok &= run_case(torch, results, "decode_attention", "B=2 S=4096 CFG holes",
                       lambda: decode_attention(q, kc, vc, mask), lambda: decode_attention_plain(q, kc, vc, mask),
                       nbytes, 4.0 * Hq * D * allowed, "bf16", library=sdpa)

    # flash prefill at the understanding prompt's shape (T = 1152 of which 92 padding, and none), against
    # SDPA with the same mask; operations counted over the allowed query-key pairs
    sdpa_fn = torch.nn.functional.scaled_dot_product_attention
    T = n_und
    for label, pads in ((f"1x{T}x{Hq}/{Hkv}x{D}, {n_pad} pads", n_pad), (f"1x{T}x{Hq}/{Hkv}x{D}, no pads", 0)):
        q = torch.randn((1, T, Hq, D), device=dev, generator=g).to(bf)
        kk = torch.randn((1, T, Hkv, D), device=dev, generator=g).to(bf)
        vv = torch.randn((1, T, Hkv, D), device=dev, generator=g).to(bf)
        valid = (torch.arange(T, device=dev) < T - pads)[None]
        pos = torch.arange(T, device=dev)
        allowed2d = (pos[None, :] <= pos[:, None]) & (valid[0][:, None] == valid[0][None, :])
        pairs = int(allowed2d.sum())
        nbytes = (2 * q.numel() + kk.numel() + vv.numel()) * 2 + T
        all_ok &= run_case(torch, results, "flash_prefill", label,
                           lambda: flash_prefill_attention(q, kk, vv, valid, scale=D**-0.5),  # noqa: B023
                           lambda: flash_prefill_attention_plain(q, kk, vv, valid, scale=D**-0.5),  # noqa: B023
                           nbytes, 4.0 * D * Hq * pairs, "bf16",
                           library=lambda: sdpa_fn(q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),  # noqa: B023
                                                   attn_mask=allowed2d[None, None], enable_gqa=True))  # noqa: B023
    # flash ViT at the pixel decoder's shape (16 heads x 1024 tokens x 64), one image and eight
    Hv, Nv, Dv = cfg.mingtok.pixel_decoder.num_heads, 1024, cfg.mingtok.pixel_decoder.embed_dim // 16
    for Bv in (1, 8):
        q, kk, vv = (torch.randn((Bv, Hv, Nv, Dv), device=dev, generator=g).to(bf) for _ in range(3))
        all_ok &= run_case(torch, results, "flash_vit", f"{Bv}x{Hv}x{Nv}x{Dv} head-major",
                           lambda: flash_vit_attention(q, kk, vv, scale=Dv**-0.5),  # noqa: B023
                           lambda: flash_vit_attention_plain(q, kk, vv, scale=Dv**-0.5),  # noqa: B023
                           4 * q.numel() * 2, 4.0 * Dv * Hv * Nv * Nv * Bv, "bf16",
                           library=lambda: sdpa_fn(q, kk, vv))  # noqa: B023
    del q, kk, vv

    # the RF head at full width, int4, its AdaLN weights at the slice's std 0.02. The random head is
    # chaotic there (a 1-ulp change of its input moves the sample by several percent over 16 steps, see
    # `--phases rf_sensitivity`), so the plain version sums in the kernel's order and the two agree
    # to the bit.
    rf_cfg = cfg.rf_head
    rf = full_width_rf(torch, rf_cfg, g, adaln_std=0.02)
    L, w, Hd, C, St = rf_cfg.depth, rf_cfg.width, rf["res_blocks"]["mlp"]["w3"]["w"].q.shape[1] * 2, \
        rf_cfg.target_channels, rf_cfg.num_sampling_steps
    ts, dts = _time_grid(rf_cfg, None, device=dev)
    for rows, renorm in ((2, False), (3, True)):
        z = torch.randn((rows, rf_cfg.z_channels), device=dev, generator=g).to(bf)
        block_mods, final_mods = precompute_modulations(rf, rf_cfg, ts, z)
        noise = torch.randn((1, C), device=dev, generator=g).repeat(rows, 1)
        args = (rf, rf_cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
        kw = dict(cfg_rows=rows, renorm_channel=renorm, compute_dtype=bf)
        # the blocks' int4 tables, their scales and biases, and the LN affines: 453 MB, more than L2 and
        # every SM's shared memory hold, so each Euler step streams them again
        block_weights = L * (w // 2 * 2 * Hd + Hd // 2 * w) + L * (2 * Hd + w) * 4 * 2 + 2 * L * w * 4
        rest = (L * St * rows * 3 * w + St * rows * 2 * w) * 4 + 2 * C * w * 4 + 2 * rows * C * 4
        nbytes = St * block_weights + rest
        ops = 2.0 * 3 * w * Hd * rows * L * St  # two integer dots per weight byte pair, per row, block and step
        all_ok &= run_case(torch, results, "rf_sampler_q4s8",
                           f"{rows} CFG rows{' + channel renorm' if renorm else ''}, w={w} H={Hd} {L} blocks "
                           f"{St} steps; tables read once would be {bound(block_weights + rest, 0, 'int8')[0]:.4f} ms",
                           lambda: rf_sample_fused(*args, **kw),  # noqa: B023
                           lambda: rf_sample_fused_plain(*args, **kw), nbytes, ops, "int8", iters=3)  # noqa: B023
    del rf
    torch.cuda.empty_cache()
    return all_ok


# ---------------------------------------------------------------------------
# phases 4-5: a small model against the fp32 reference, then the slice, both
# through the port's session
# ---------------------------------------------------------------------------


def t2i_prompt(vocab: int, image_start: int):
    """A ~40-id text-to-image prompt with the chat role-prefix runs, and its
    CFG masks from the processor's rule (no tokenizer on the card)."""
    import numpy as np

    from mingunivision_tpu_torch.processing.processor import build_cfg_masks

    rng = np.random.default_rng(7)
    user_prefix = [1001, 1002, 1003]  # stands for "<role>HUMAN</role>"
    asst_prefix = [1001, 1004, 1003]  # stands for "<role>ASSISTANT</role>"
    text = rng.integers(2000, vocab - 1000, 31).tolist()
    ids = user_prefix + text + asst_prefix
    uncond, text_uncond = build_cfg_masks(ids, user_prefix, asst_prefix, {image_start})
    as_row = lambda a: np.asarray([a], np.int64)  # noqa: E731
    return as_row(ids), as_row([1] * len(ids)), as_row(uncond), as_row(text_uncond)


USER_TAG, ASSISTANT_TAG = [1001, 1002, 1003], [1001, 1004, 1003]  # stand for the role-prefix id runs


def image_prompt(cfg, n_patches: int, n_text: int, seed: int):
    """An image prompt built by hand (the card's machine has no tokenizer and
    no PIL): role tag, <image>, `n_patches` image-patch ids, </image>, `n_text`
    text ids, assistant tag; and its CFG masks from the processor's rule."""
    import numpy as np

    from mingunivision_tpu_torch.processing.processor import build_cfg_masks

    llm = cfg.llm
    image_end = llm.image_start_token + 1
    text = np.random.default_rng(seed).integers(2000, min(llm.vocab_size, llm.image_patch_token) - 1000, n_text).tolist()
    ids = USER_TAG + [llm.image_start_token] + [llm.image_patch_token] * n_patches + [image_end] + text + ASSISTANT_TAG
    uncond, text_uncond = build_cfg_masks(ids, USER_TAG, ASSISTANT_TAG,
                                          {llm.image_start_token, llm.image_patch_token, image_end})
    as_row = lambda a: np.asarray([a], np.int64)  # noqa: E731
    return as_row(ids), as_row([1] * len(ids)), as_row(uncond), as_row(text_uncond)


def pixel_values(size: int, seed: int, batch: int = 1):
    """A (batch, 3, size, size) fp32 image in [-1, 1] from a numpy seed."""
    import numpy as np

    return np.tanh(np.random.default_rng(seed).standard_normal((batch, 3, size, size), dtype=np.float32))


def _set_head_columns(params, cols, scale):
    """Multiply lm_head columns `cols` by `scale` (an int4 table's per-column scales)."""
    from mingunivision_tpu_torch.utils.quantize import QuantizedArray

    w = params["llm"]["lm_head"]["w"]
    if isinstance(w, QuantizedArray):
        w.s[..., cols] = w.s[..., cols] * scale
    else:
        w[:, cols] = w[:, cols] * scale


def steer_text_head(params, cfg):
    """Make a greedy text round the same every run and at every precision: the
    lm_head columns of <eos> and <image> are zeroed, so the round neither stops
    nor starts an image, and 16 word columns are made 25 times larger, so the
    argmax is decided among them by gaps far above bf16's rounding."""
    _set_head_columns(params, [cfg.llm.eos_token_id, cfg.llm.image_start_token], 0.0)
    _set_head_columns(params, [3000 + 997 * i for i in range(16)], 25.0)


def bias_to_image_start(torch, params, cfg, ids, device, pixels=None):
    """Bias the lm_head column of <image> so that greedy decoding picks it after
    the prompt, as the engine tests do. The column is set to +-10 (in an int4
    table: nibbles +-7 at scale 10/7): a probe prefill of the prompt (with the
    image `pixels` encoded and scattered over it, when given) picks the sign
    that makes its logit large and positive."""
    from mingunivision_tpu_torch.engine.generate import linear_proj_apply, prefill, scatter_image_embeds
    from mingunivision_tpu_torch.models.bailing_moe import LLMCache, embed_tokens
    from mingunivision_tpu_torch.models.mingtok import mingtok_encode
    from mingunivision_tpu_torch.utils.quantize import QuantizedArray

    img = cfg.llm.image_start_token
    w = params["llm"]["lm_head"]["w"]

    def set_column(sign):
        if isinstance(w, QuantizedArray):
            w.q[:, img] = 0xFF if sign > 0 else 0x11  # both nibbles 15 (+7) or 1 (-7)
            w.s[..., img] = 10.0 / 7.0
        else:
            w[:, img].fill_(10.0 * sign)

    set_column(1)
    T = ids.shape[1]
    T_pad = -(-T // 128) * 128
    cache = LLMCache.create(cfg.llm, 1, T_pad, torch.bfloat16, device)
    mask = torch.zeros((1, T_pad), dtype=torch.bool, device=device)
    mask[:, :T] = True
    ids_pad = torch.zeros((1, T_pad), dtype=torch.long, device=device)
    ids_pad[:, :T] = torch.as_tensor(ids, device=device)
    embeds = embed_tokens(params["llm"], ids_pad).to(torch.bfloat16)
    image_mask = None
    if pixels is not None:
        feats = mingtok_encode(params["mingtok"], cfg.mingtok, torch.as_tensor(pixels, device=device))
        proj = linear_proj_apply(params["linear_proj"], feats["x_norm_patchtokens"].float())
        embeds, image_mask = scatter_image_embeds(embeds, ids_pad, proj.reshape(-1, proj.shape[-1]),
                                                  cfg.llm.image_patch_token)
    logits, _ = prefill(params["llm"], cfg.llm, embeds, cache, mask, image_mask=image_mask)
    if float(logits[0, img]) < 0:
        set_column(-1)


def randomize_adaln(params, generator):
    """Draw the RF head's zero-initialised AdaLN and final layers at std 0.02, so
    the sampled latents, and so the image, depend on the LLM's hidden states."""
    rf = params["rf_head"]
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.02, generator=generator)


def _generate(torch, params, cfg, runtime, device, prompt, image_gen=None, pixels=None, max_new_tokens=1):
    """One round through the port's session (a new session, so an empty cache);
    returns (output, session, seconds)."""
    from mingunivision_tpu_torch.config import GenerationConfig
    from mingunivision_tpu_torch.engine.session import MingUniVisionSession

    ids, am, um, tm = prompt
    sess = MingUniVisionSession(params, cfg, runtime, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sess.generate(ids, am, uncond_attention_mask=um, text_uncond_attention_mask=tm, pixel_values=pixels,
                        generation=GenerationConfig(max_new_tokens=max_new_tokens), image_gen=image_gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, sess, time.perf_counter() - t0


def image_checks(out, sess, cfg, T, size, rows=2):
    import numpy as np

    n_tok = cfg.image_gen.num_image_tokens
    img = out.images[0] if len(out.images) == 1 else None
    checks = [("one image", img is not None)]
    if img is not None:
        checks += [(f"shape (3, {size}, {size})", tuple(img.shape) == (3, size, size)),
                   ("finite", bool(np.isfinite(img).all())),
                   ("in [-1, 1]", bool(img.min() >= -1.0 and img.max() <= 1.0))]
    checks += [("first token <image>", out.token_ids[:1] == [cfg.llm.image_start_token]),
               (f"seq_len == T + {n_tok + 1}", sess.seq_len == T + n_tok + 1),
               (f"{rows} CFG rows", sess.timings.get("cfg_rows") == rows)]
    return checks


# the model-level entry points the main paths call the kernels by (the MoE
# entries dispatch bf16 and int4 tables to their kernels themselves)
ENTRIES = ("moe_stream", "moe_swiglu_gmm", "decode_attention", "rf_sampler", "flash_prefill", "moe_capacity", "flash_vit")


@contextlib.contextmanager
def plain_versions(names=ENTRIES):
    """Route the main path's calls of the named entry points to their plain
    versions for the block (the names the model modules call them by are patched)."""
    from mingunivision_tpu_torch.models import bailing_moe as bm
    from mingunivision_tpu_torch.models import rf_head, vit
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.flash import flash_prefill_attention_plain, flash_vit_attention_plain
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import moe_experts_capacity_gmm_exact_plain
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_plain
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_plain
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused_plain

    swaps = {"moe_stream": (bm, "moe_experts_stream", moe_experts_stream_plain),
             "moe_swiglu_gmm": (bm, "moe_experts_swiglu_gmm", moe_experts_swiglu_gmm_plain),
             "decode_attention": (bm, "decode_attention", decode_attention_plain),
             "rf_sampler": (rf_head, "rf_sample_fused", rf_sample_fused_plain),
             "flash_prefill": (bm, "flash_prefill_attention", flash_prefill_attention_plain),
             "moe_capacity": (bm, "moe_experts_capacity_gmm_exact", moe_experts_capacity_gmm_exact_plain),
             "flash_vit": (vit, "flash_vit_attention", flash_vit_attention_plain)}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps.values()]
    for name in names:
        setattr(*swaps[name])
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def small_model(torch, device, tier="bfloat16"):
    """A 2-layer model with the full model's structure, bf16 on the card (the
    LLM and RF head then quantized when `tier` is "int4"; the RF head is wide
    enough, 192 x 512, for every table to pass the quantizer's size floor), RF
    noise off (temperature 0), 16 image tokens; returns (cfg, params, prompt)."""
    import dataclasses

    from mingunivision_tpu_torch.config import ImageGenConfig, MingUniVisionConfig
    from mingunivision_tpu_torch.utils.convert import init_mm_params, quantize_mm_params_inplace

    base = MingUniVisionConfig()
    llm = dataclasses.replace(base.llm, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=64, moe_intermediate_size=128, num_experts=8,
                              num_experts_per_tok=2)
    rf = dataclasses.replace(base.rf_head, target_channels=8, z_channels=64, width=64 if tier == "bfloat16" else 192,
                             depth=2)
    mt = base.mingtok
    mingtok = dataclasses.replace(
        mt, scaling_factor=2.0, mean=0.5,
        encoder=dataclasses.replace(mt.encoder, img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2, out_dim=8),
        semantic_decoder=dataclasses.replace(mt.semantic_decoder, in_dim=8, embed_dim=64, depth=2, num_heads=2,
                                             patch_size=16),
        pixel_decoder=dataclasses.replace(mt.pixel_decoder, embed_dim=64, depth=2, num_heads=2, patch_size=8),
    )
    cfg = dataclasses.replace(base, llm=llm, rf_head=rf, mingtok=mingtok,
                              image_gen=ImageGenConfig(num_image_tokens=16, temperature=0.0))
    gen = torch.Generator(device=device).manual_seed(1)
    params = init_mm_params(cfg, device=device, dtype=torch.bfloat16, generator=gen)
    randomize_adaln(params, gen)
    if tier != "bfloat16":
        quantize_mm_params_inplace(params)
    prompt = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, prompt[0], device)
    return cfg, params, prompt


def as_f32(params):
    """The tree with every floating leaf in fp32 (quantized leaves as they are)."""
    from mingunivision_tpu_torch.utils.pytree import tree_map
    from mingunivision_tpu_torch.utils.quantize import QuantizedArray

    return tree_map(lambda t: t if isinstance(t, QuantizedArray) else t.float(), params)


@contextlib.contextmanager
def loop_capture():
    """For the block, record what each T2I round's image loop computes, per
    loop step: the LLM hidden state that enters the image head (B, h), the RF
    latent sampled from it (B, C), and the semantic token the loop emits.
    Yields a dict whose "hidden", "latent" and "sem" hold the last round's
    arrays, stacked over the steps."""
    import numpy as np

    from mingunivision_tpu_torch.engine import generate as gen_mod
    from mingunivision_tpu_torch.engine import session as session_mod

    seen = {}
    loop, vis_head, sample = session_mod.generate_image_tokens, gen_mod.vis_head_apply, gen_mod.rf_sample

    def capture_loop(*args, **kwargs):
        seen.update(hidden=[], latent=[])
        res = loop(*args, **kwargs)
        seen.update(hidden=np.stack(seen["hidden"]), latent=np.stack(seen["latent"]),
                    sem=res.sem_tokens[0].float().cpu().numpy())
        return res

    def capture_hidden(p, x):
        seen["hidden"].append(x.float().cpu().numpy())
        return vis_head(p, x)

    def capture_latent(*args, **kwargs):
        latent = sample(*args, **kwargs)
        seen["latent"].append(latent.float().cpu().numpy())
        return latent

    session_mod.generate_image_tokens, gen_mod.vis_head_apply, gen_mod.rf_sample = \
        capture_loop, capture_hidden, capture_latent
    try:
        yield seen
    finally:
        session_mod.generate_image_tokens, gen_mod.vis_head_apply, gen_mod.rf_sample = loop, vis_head, sample


def run_reference(torch, device, tier="bfloat16") -> bool:
    """The small model through the kernels (bf16) and through their plain
    versions in fp32, the reference, on the same weights (`tier`: bf16, or the
    int4 tree). The kernel path must give the reference's tokens, and where the
    kernels first act, before the 16-token loop grows any bf16 ulp into an image
    difference, it may differ from the reference by at most twice the plain
    bf16 path's own error, plus 1e-2 of the reference's maximum: the hidden
    state that enters the image head at loop step 0 (prefill and one decode
    step: every LLM kernel) and the first RF latent (sampled from that hidden
    state: the int4 sampler). The image is held to shape, finite and in
    range; its errors are printed."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig

    cfg, params, prompt = small_model(torch, device, tier)
    bf16 = RuntimeConfig(max_seq_len=512)
    with loop_capture() as seen:
        out_k, sess_k, _ = _generate(torch, params, cfg, bf16, device, prompt, cfg.image_gen)
        kern = (seen["hidden"][0], seen["latent"][0])
        with plain_versions():
            out_r = _generate(torch, as_f32(params), cfg, RuntimeConfig(max_seq_len=512, compute_dtype="float32"),
                              device, prompt, cfg.image_gen)[0]
            ref = (seen["hidden"][0], seen["latent"][0])
            out_p = _generate(torch, params, cfg, bf16, device, prompt, cfg.image_gen)[0]
            plain = (seen["hidden"][0], seen["latent"][0])
    checks = image_checks(out_k, sess_k, cfg, prompt[0].shape[1], cfg.mingtok.encoder.img_size)
    checks.append(("tokens == fp32 reference", out_k.token_ids == out_r.token_ids))
    for i, what in enumerate(("step-0 hidden", "first latent")):
        scale = float(np.abs(ref[i]).max())
        err_k, err_p = (float(np.abs(run[i] - ref[i]).max()) for run in (kern, plain))
        tol = 2 * err_p + 1e-2 * scale
        checks.append((f"{what} err vs fp32 {err_k:.3e} <= {tol:.3e} (plain bf16 err {err_p:.3e}, "
                       f"max |ref| {scale:.3e})", bool(np.isfinite(kern[i]).all()) and err_k <= tol))
    img_err = [float(np.abs(o.images[0] - out_r.images[0]).max()) if len(o.images) == 1 else float("inf")
               for o in (out_k, out_p)]
    print(f"reference ({tier} small model on the card: kernels bf16 vs plain fp32): "
          + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks)
          + f"; image err vs fp32 (not held) kernels {img_err[0]:.3e}, plain bf16 {img_err[1]:.3e}")
    return all(p for _, p in checks)


@contextlib.contextmanager
def prefill_capture():
    """For the block, record the hidden state of the prompt's last valid position
    that each round's prefill hands to the LM head, (1, 1, h); yields a dict
    whose "hidden" holds the last round's."""
    from mingunivision_tpu_torch.engine import generate as gen_mod
    from mingunivision_tpu_torch.engine import session as session_mod

    seen = {}
    prefill, logits_fn = session_mod.prefill, gen_mod.compute_logits

    def capture_prefill(*args, **kwargs):
        seen.pop("hidden", None)
        return prefill(*args, **kwargs)

    def capture_hidden(params, cfg, hidden):
        seen.setdefault("hidden", hidden.float().cpu().numpy())  # the round's first call is the prefill's
        return logits_fn(params, cfg, hidden)

    session_mod.prefill, gen_mod.compute_logits = capture_prefill, capture_hidden
    try:
        yield seen
    finally:
        session_mod.prefill, gen_mod.compute_logits = prefill, logits_fn


def run_reference_image(torch, device, tier="bfloat16") -> bool:
    """The small model on an image prompt that pads to 512 tokens: a 128-px image
    (64 patch tokens, the encoder's positional embedding interpolated) and 380
    text ids, then 4 greedy text tokens. The kernel path (bf16: the encoder,
    flash prefill, the capacity MoE dispatch, then the decode kernels) against
    the plain versions in fp32 on the same weights: the same tokens, and the
    prefill's last-position hidden state within twice the plain bf16 path's own
    error plus 1e-2 of the reference's maximum."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig

    cfg, params, _ = small_model(torch, device, tier)
    steer_text_head(params, cfg)
    prompt, pixels = image_prompt(cfg, 64, 380, seed=11), pixel_values(128, seed=12)
    bf16 = RuntimeConfig(max_seq_len=1024)
    kw = dict(pixels=pixels, max_new_tokens=4)
    with prefill_capture() as seen:
        out_k, sess_k, _ = _generate(torch, params, cfg, bf16, device, prompt, **kw)
        kern = seen["hidden"]
        with plain_versions():
            out_r = _generate(torch, as_f32(params), cfg, RuntimeConfig(max_seq_len=1024, compute_dtype="float32"),
                              device, prompt, **kw)[0]
            ref = seen["hidden"]
            out_p = _generate(torch, params, cfg, bf16, device, prompt, **kw)[0]
            plain = seen["hidden"]
    scale = float(np.abs(ref).max())
    err_k, err_p = float(np.abs(kern - ref).max()), float(np.abs(plain - ref).max())
    tol = 2 * err_p + 1e-2 * scale
    t = sess_k.timings
    checks = [("prompt padded to 512", t["prefill_tokens"] == 512), ("flash prefill", bool(t["use_flash"])),
              ("4 text tokens, no image", len(out_k.token_ids) == 4 and not out_k.images),
              ("tokens == fp32 reference", out_k.token_ids == out_r.token_ids),
              (f"prefill last-position hidden err vs fp32 {err_k:.3e} <= {tol:.3e} (plain bf16 err {err_p:.3e}, "
               f"max |ref| {scale:.3e})", bool(np.isfinite(kern).all()) and err_k <= tol)]
    print(f"reference ({tier} small model on the card, image prompt: kernels bf16 vs plain fp32): "
          + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks)
          + f"; tokens {out_k.token_ids}, plain bf16 {out_p.token_ids}")
    return all(p for _, p in checks)


def run_divergence(torch, device) -> bool:
    """Where the small model's bf16 paths part: the plain bf16 path, each kernel
    alone swapped into it, all three kernels, and the plain fp32 reference.
    Against the plain bf16 path and against fp32, the max abs error of: the
    LLM's hidden state that enters the image head at loop step 0 (prefill and
    one decode step: the only place the kernels act before the plain RF head
    and semantic decoder) and at any of the 16 steps; the semantic token the
    loop emits, at step 0 and at any step; the image. A kernel fault shows as a
    step-0 hidden-state error well above what bf16 costs the plain path."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig

    cfg, params, prompt = small_model(torch, device)
    kernels = BF16_KERNELS  # the small bf16 model's entry points, named as their kernels

    def run(params, plain, compute_dtype="bfloat16"):
        with plain_versions(plain):
            out, _, _ = _generate(torch, params, cfg, RuntimeConfig(max_seq_len=512, compute_dtype=compute_dtype),
                                  device, prompt, cfg.image_gen)
        return seen["hidden"], seen["sem"], out.images[0]

    with loop_capture() as seen:
        ref = run(as_f32(params), kernels, "float32")
        base = run(params, kernels)
        variants = {"plain bf16": base, "all kernels": run(params, ())}
        for name in kernels:
            variants[f"only {name}"] = run(params, tuple(n for n in kernels if n != name))
    print(f"divergence: small model, {cfg.image_gen.num_image_tokens} image tokens; fp32 max |hidden| "
          f"{np.abs(ref[0]).max():.3e}, max |sem| {np.abs(ref[1]).max():.3e}")
    ok = True
    for label, (hid, sem, img) in variants.items():
        errs = []
        for o_hid, o_sem, o_img in (base, ref):
            e_hid = np.abs(hid - o_hid).reshape(len(hid), -1).max(axis=-1)
            e_sem = np.abs(sem - o_sem).max(axis=-1)
            errs.append(f"hidden step0 {e_hid[0]:.3e} any {e_hid.max():.3e}, sem step0 {e_sem[0]:.3e} "
                        f"any {e_sem.max():.3e}, image {np.abs(img - o_img).max():.3e}")
        ok &= bool(np.isfinite(hid).all() and np.isfinite(sem).all() and np.isfinite(img).all())
        print(f"divergence [{label}]: vs plain bf16: {errs[0]} | vs fp32: {errs[1]}")
    return ok


def full_model(torch, cfg, device, tier="bfloat16"):
    """Random bf16 weights of `cfg` on the device from seed 0; for `tier` "int4"
    the LLM and RF head are then quantized in place on the device, leaf by
    leaf. Returns params."""
    from mingunivision_tpu_torch.utils.convert import init_mm_params, quantize_mm_params_inplace
    from mingunivision_tpu_torch.utils.pytree import leaves

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_mm_params(cfg, device=device, dtype=torch.bfloat16, generator=gen)
    randomize_adaln(params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"init: {n_params / 1e9:.3f} B params bf16 on device in {time.perf_counter() - t0:.1f} s "
          f"(allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    if tier != "bfloat16":
        t0 = time.perf_counter()
        quantize_mm_params_inplace(params)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"quantize: LLM and RF head to {tier} on device in {time.perf_counter() - t0:.1f} s "
              f"(peak so far {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; resident "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB)")
    return params


def launch_counters():
    """kernel name -> the wrapper that counts its launches ("moe_capacity": the
    launches of the prefill MoE kernels that went through the capacity dispatch)."""
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention
    from mingunivision_tpu_torch.ops.kernels.flash import flash_prefill_attention, flash_vit_attention
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import moe_experts_capacity_gmm
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream, moe_experts_stream_q4s8
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_q4
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused

    return {"moe_stream": moe_experts_stream, "moe_swiglu_gmm": moe_experts_swiglu_gmm,
            "decode_attention": decode_attention, "moe_stream_q4s8": moe_experts_stream_q4s8,
            "moe_swiglu_gmm_q4": moe_experts_swiglu_gmm_q4, "rf_sampler_q4s8": rf_sample_fused,
            "flash_prefill": flash_prefill_attention, "flash_vit": flash_vit_attention,
            "moe_capacity": moe_experts_capacity_gmm}


def counted_round(torch, results, path, run):
    """Drive one main path: every launch count set to 0 just before `run()`,
    read just after; peak memory over it. The counts are kept under the
    kernels' `launches_by_path[path]`. Returns (run's result, launches, peak bytes)."""
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = run()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})[path] = n
    return res, launches, torch.cuda.max_memory_allocated()


def report(label, launches, checks) -> bool:
    print(f"{label} launches: " + ", ".join(f"{name}={n}" for name, n in launches.items()))
    print(f"{label} checks: " + "; ".join(f"{lab}={'ok' if p else 'FAILED'}" for lab, p in checks))
    return all(p for _, p in checks)


def launch_checks(launches, floors):
    """The kernels of a path must reach their floors (and none may be 0); the others must not launch."""
    checks = [(f"{name} launches {launches[name]} >= {floor} > 0", launches[name] >= floor > 0)
              for name, floor in floors.items()]
    return checks + [(f"{name} launches {n} == 0", n == 0) for name, n in launches.items() if name not in floors]


def tier_kernels(tier):
    """(decode MoE, prefill MoE) kernel names of a tier."""
    return ("moe_stream", "moe_swiglu_gmm") if tier == "bfloat16" else ("moe_stream_q4s8", "moe_swiglu_gmm_q4")


def run_slice(torch, cfg, params, device, results: dict, tier="bfloat16") -> bool:
    """One full-width T2I round at `tier`, with every kernel's launch count read
    around it; the kernels of the tier's path must reach their floors (per LLM
    step and layer for the decode kernels, per layer for the prefill one, per
    image token for the RF sampler) and the others must not launch."""
    from mingunivision_tpu_torch.config import RuntimeConfig

    L = cfg.llm.num_hidden_layers
    n_tok = cfg.image_gen.num_image_tokens
    prompt = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, prompt[0], device)
    resident = torch.cuda.memory_allocated()
    label = "slice" if tier == "bfloat16" else f"slice_{tier}"
    (out, sess, total_s), launches, peak = counted_round(
        torch, results, label, lambda: _generate(torch, params, cfg, RuntimeConfig(), device, prompt))

    T = prompt[0].shape[1]
    decode_moe, prefill_moe = tier_kernels(tier)
    floors = {decode_moe: L * (n_tok + 1), prefill_moe: L, "decode_attention": L * (n_tok + 1)}
    if tier != "bfloat16":
        floors["rf_sampler_q4s8"] = n_tok
    checks = image_checks(out, sess, cfg, T, 512) + launch_checks(launches, floors)
    t = sess.timings
    print(f"{label} T2I: prompt {T} ids (bucket 128), {L} layers, {tier}, cfg_rows={t.get('cfg_rows')}, "
          f"prefill_ms={t['prefill_ms']:.2f} image_loop_ms={t['image_loop_ms']:.1f} "
          f"ms_per_ar_token={t['image_loop_ms'] / n_tok:.3f} pixel_decode_ms={t['pixel_decode_ms']:.2f} "
          f"total_s={total_s:.3f} resident_gib={resident / 2**30:.3f} max_memory_allocated_gib={peak / 2**30:.3f}")
    for name in floors:
        results[name]["launches"] = launches[name]
    return report(label, launches, checks)


def run_understand(torch, cfg, params, device, results: dict, tier="bfloat16", new_tokens: int = 32) -> bool:
    """Image -> text at full width on the tier's model: a 1024-px image (1,024
    patch tokens in a 1,060-id prompt that pads to 1,152) through the MingTok
    encoder, a first-round prefill through the flash kernel and the capacity
    MoE dispatch (image rows routed by the image gate), then greedy text decode
    through the decode kernels. Every kernel of the path must have launched,
    the prefill MoE kernel at least once through the capacity dispatch.

    The attention outputs of the random model are damped first
    (`damp_attention_outputs`): as initialised, its 1,024 image rows come out
    of MingTok nearly parallel, route to the same six experts in every layer
    and overflow the capacity (`--phases routing` shows both)."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import moe_experts_capacity_gmm_exact

    L = cfg.llm.num_hidden_layers
    steer_text_head(params, cfg)
    damp_attention_outputs(params)
    prompt, pixels = image_prompt(cfg, 1024, 28, seed=21), pixel_values(1024, seed=22)
    fallbacks = moe_experts_capacity_gmm_exact.fallbacks
    label = f"understand_{tier}"
    (out, sess, total_s), launches, peak = counted_round(
        torch, results, label, lambda: _generate(torch, params, cfg, RuntimeConfig(), device, prompt, pixels=pixels,
                                                 max_new_tokens=new_tokens))
    fallbacks = moe_experts_capacity_gmm_exact.fallbacks - fallbacks
    t = sess.timings
    T, steps = prompt[0].shape[1], t["text_tokens"]
    decode_moe, prefill_moe = tier_kernels(tier)
    floors = {"flash_prefill": L, prefill_moe: L, decode_moe: L * steps, "decode_attention": L * steps,
              "moe_capacity": max(1, L - fallbacks)}
    checks = [("T_pad == 1152", t["prefill_tokens"] == 1152), ("flash prefill", bool(t["use_flash"])),
              (f"{new_tokens} text tokens, no image", len(out.token_ids) == new_tokens and not out.images),
              (f"{new_tokens - 1} decode steps", steps == new_tokens - 1),
              ("seq_len == T + steps", sess.seq_len == T + steps),
              ("hidden states finite", bool(np.isfinite(sess.last_hidden_states).all())),
              (f"flash_prefill launches == {L}", launches["flash_prefill"] == L),
              (f"capacity dispatch {launches['moe_capacity']} + fallbacks {fallbacks} == {L}",
               launches["moe_capacity"] + fallbacks == L),
              (f"{prefill_moe} launches == {L}", launches[prefill_moe] == L)]
    checks += launch_checks(launches, floors)
    print(f"{label}: prompt {T} ids (1024 image-patch ids; bucket {t['prefill_tokens']}), {L} layers, {tier}, "
          f"encode_ms={t['encode_ms']:.2f} prefill_ms={t['prefill_ms']:.2f} "
          f"prefill_tokens_per_s={t['prefill_tokens'] / t['prefill_ms'] * 1e3:.1f} "
          f"text_decode_ms={t['text_decode_ms']:.1f} ms_per_text_token={t['text_decode_ms'] / max(steps, 1):.3f} "
          f"capacity_dispatch_launches={launches['moe_capacity']} capacity_fallbacks={fallbacks} "
          f"total_s={total_s:.3f} max_memory_allocated_gib={peak / 2**30:.3f}")
    results["flash_prefill"]["launches"] = launches["flash_prefill"]
    return report(label, launches, checks)


def damp_attention_outputs(params, factor: float = 0.1):
    """Scale the attention output projections of the LLM and of MingTok's
    encoder and semantic decoder by `factor`, in place. A deep stack of
    randomly initialised attention blocks adds nearly the same vector (a mean
    over all tokens) to every row, layer after layer, until the rows are close
    to parallel and the router sends them all to the same experts; trained
    weights keep rows distinct. Damping that shared term keeps the rows of a
    random model distinct, so its routing spreads as a trained model's does."""
    from mingunivision_tpu_torch.utils.quantize import QuantizedArray

    leaves = [params["llm"]["layers"]["attention"]["dense"]["w"]]
    leaves += [params["mingtok"][part]["blocks"]["attn"]["proj"]["w"] for part in ("encoder", "semantic_decoder")]
    for w in leaves:
        (w.s if isinstance(w, QuantizedArray) else w).mul_(factor)


def run_routing(torch, cfg, device, tier="bfloat16") -> bool:
    """How the understanding prompt routes, layer by layer, on the tier's
    full-width random model as initialised and with the attention outputs
    damped: the largest expert load among the valid rows (all, the 1,024
    image rows, the text rows) against the capacity, the experts in use, and
    whether the capacity dispatch fits or falls back."""
    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.models import bailing_moe as bm

    params = full_model(torch, cfg, device, tier)
    steer_text_head(params, cfg)
    prompt, pixels = image_prompt(cfg, 1024, 28, seed=21), pixel_values(1024, seed=22)
    is_image = torch.as_tensor(prompt[0][0] == cfg.llm.image_patch_token, device=device)
    E = cfg.llm.num_experts
    exact = bm.moe_experts_capacity_gmm_exact
    rows = []

    def record(experts, x_flat, topk_idx, topk_w, num_experts, capacity, *, token_valid=None, layer_idx=None):
        n = is_image.numel()
        loads = [int(torch.bincount(topk_idx[:n][sel].reshape(-1), minlength=E).max())
                 for sel in (slice(None), is_image, ~is_image)]
        used = int((torch.bincount(topk_idx[:n].reshape(-1), minlength=E) > 0).sum())
        rows.append((layer_idx, capacity, *loads, used))
        return exact(experts, x_flat, topk_idx, topk_w, num_experts, capacity, token_valid=token_valid,
                     layer_idx=layer_idx)

    ok = True
    for label in ("as initialised", "attention output projections x0.1"):
        if label != "as initialised":
            damp_attention_outputs(params)
        rows.clear()
        bm.moe_experts_capacity_gmm_exact = record
        try:
            out, sess, _ = _generate(torch, params, cfg, RuntimeConfig(), device, prompt, pixels=pixels, max_new_tokens=2)
        finally:
            bm.moe_experts_capacity_gmm_exact = exact
        fits = sum(1 for r in rows if r[2] <= r[1])
        print(f"routing [{tier}, {label}]: {fits} of {len(rows)} layers fit capacity {rows[0][1]}; per layer "
              "(max load all / image rows / text rows, experts in use): "
              + " ".join(f"L{r[0]}:{r[2]}/{r[3]}/{r[4]},{r[5]}" for r in rows))
        ok &= len(rows) == cfg.llm.num_hidden_layers and len(out.token_ids) == 2
    return ok


def run_edit(torch, cfg, params, device, results: dict, tier="int4") -> bool:
    """Image + edit request -> image at full width on the tier's model: a 512-px
    image (256 patch tokens; the prompt pads to 384, so plain prefill attention
    and the expert-sorted MoE dispatch), then the 256-token image loop with 3
    CFG rows (the text-uncond row keeps the image tokens, the uncond row drops
    the whole turn) and the pixel decode."""
    from mingunivision_tpu_torch.config import RuntimeConfig

    L = cfg.llm.num_hidden_layers
    n_tok = cfg.image_gen.num_image_tokens
    prompt, pixels = image_prompt(cfg, 256, 30, seed=31), pixel_values(512, seed=32)
    bias_to_image_start(torch, params, cfg, prompt[0], device, pixels=pixels)
    label = f"edit_{tier}"
    (out, sess, total_s), launches, peak = counted_round(
        torch, results, label, lambda: _generate(torch, params, cfg, RuntimeConfig(), device, prompt, pixels=pixels))
    t = sess.timings
    T = prompt[0].shape[1]
    decode_moe, prefill_moe = tier_kernels(tier)
    floors = {decode_moe: L * (n_tok + 1), prefill_moe: L, "decode_attention": L * (n_tok + 1)}
    if tier != "bfloat16":
        floors["rf_sampler_q4s8"] = n_tok
    checks = image_checks(out, sess, cfg, T, 512, rows=3) + [("T_pad == 384", t["prefill_tokens"] == 384)]
    if tier != "bfloat16":
        checks.append((f"sampler launches == {n_tok}", launches["rf_sampler_q4s8"] == n_tok))
    checks += launch_checks(launches, floors)
    print(f"{label}: prompt {T} ids (256 image-patch ids; bucket {t['prefill_tokens']}), {L} layers, {tier}, "
          f"cfg_rows={t.get('cfg_rows')}, encode_ms={t['encode_ms']:.2f} prefill_ms={t['prefill_ms']:.2f} "
          f"image_loop_ms={t['image_loop_ms']:.1f} ms_per_ar_token={t['image_loop_ms'] / n_tok:.3f} "
          f"pixel_decode_ms={t['pixel_decode_ms']:.2f} total_s={total_s:.3f} "
          f"max_memory_allocated_gib={peak / 2**30:.3f}")
    return report(label, launches, checks)


def run_recon(torch, cfg, device, results: dict) -> bool:
    """MingTok reconstruction (`mingtok_enc_dec`: image -> latents -> features ->
    image) at 512 px and full width, random bf16 weights from a seed, batch 1
    and 8, on the pixel decoder's "high" tier (true fp32, no flash kernel) and
    its reduced tiers "default" and "bf16" (24 non-causal flash-ViT launches per
    batch): shapes, finite, range, the reduced tiers' PSNR against "high" (peak
    to peak 2), and the time per image (the second of two runs)."""
    import dataclasses
    import math

    from mingunivision_tpu_torch.models.mingtok import mingtok_enc_dec
    from mingunivision_tpu_torch.utils.convert import _Init, init_mingtok_params

    mt = cfg.mingtok
    depth = mt.pixel_decoder.depth
    params = init_mingtok_params(mt, _Init(device, torch.bfloat16, torch.Generator(device=device).manual_seed(3)))
    ok = True
    for batch in (1, 8):
        images = torch.as_tensor(pixel_values(512, seed=40 + batch, batch=batch), device=device)
        outs = {}
        for tier in ("high", "default", "bf16"):
            tcfg = dataclasses.replace(mt, pixel_decoder=dataclasses.replace(mt.pixel_decoder, matmul_precision=tier))

            def run():
                mingtok_enc_dec(params, tcfg, images)  # noqa: B023  (warm-up)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = mingtok_enc_dec(params, tcfg, images)  # noqa: B023
                torch.cuda.synchronize()
                return out, (time.perf_counter() - t0) * 1e3

            (out, ms), launches, peak = counted_round(torch, results, f"recon_{tier}_b{batch}", run)
            outs[tier] = out
            want = 0 if tier == "high" else 2 * depth  # two runs
            checks = [(f"shape ({batch}, 3, 512, 512) fp32", tuple(out.shape) == (batch, 3, 512, 512)
                       and out.dtype == torch.float32),
                      ("finite", bool(torch.isfinite(out).all())),
                      ("in [-1, 1]", bool(out.min() >= -1.0 and out.max() <= 1.0)),
                      (f"flash_vit launches {launches['flash_vit']} == {want} (2 runs x {depth} blocks)",
                       launches["flash_vit"] == want)]
            checks += [(f"{name} launches {n} == 0", n == 0) for name, n in launches.items() if name != "flash_vit"]
            psnr = ""
            if tier != "high":
                mse = float(((out - outs["high"]) ** 2).mean())
                db = 10 * math.log10(4.0 / max(mse, 1e-20))
                rel = float((out - outs["high"]).norm() / outs["high"].norm())
                psnr = f" psnr_vs_high_db={db:.2f} rel_l2_vs_high={rel:.3e}"
                checks.append((f"PSNR vs high {db:.2f} dB >= 30", db >= 30.0))
                results["flash_vit"]["launches"] = launches["flash_vit"] // 2
            print(f"recon [{tier}, batch {batch}]: ms_per_batch={ms:.2f} ms_per_image={ms / batch:.2f}{psnr} "
                  f"flash_vit_launches_per_batch={launches['flash_vit'] // 2} "
                  f"max_memory_allocated_gib={peak / 2**30:.3f} "
                  + "; ".join(f"{lab}={'ok' if p else 'FAILED'}" for lab, p in checks))
            ok &= all(p for _, p in checks)
    return ok


# stage -> (module under engine/, the name the round calls the stage by there)
STAGES = {"prefill": ("session", "prefill"), "llm_forward": ("generate", "bailing_forward"),
          "vis_head": ("generate", "vis_head_apply"), "rf_sample": ("generate", "rf_sample"),
          "semdec_step": ("generate", "mingtok_feature_decoder"), "linear_proj": ("generate", "linear_proj_apply"),
          "pixel_decoder": ("generate", "mingtok_pixel_decoder")}


def stage_device_ms(device_events, stages=None) -> dict:
    """stage -> [calls, device ms of the events inside the stage's ranges on the
    device timeline]. A range's device span runs from its first to its last
    kernel; the kernels built in csrc/ launch through ctypes, with no PyTorch
    op to hang them on in the host-side tree, so they are placed by time."""
    import bisect
    import itertools

    spans = {stage: [] for stage in (stages or STAGES)}
    kernels = []
    for e in device_events:
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        else:
            kernels.append((e.time_range.start, e.time_range.elapsed_us()))
    kernels.sort()
    starts = [start for start, _ in kernels]
    cum = list(itertools.accumulate((us for _, us in kernels), initial=0))
    return {stage: [len(ranges), sum(cum[bisect.bisect_right(starts, end)] - cum[bisect.bisect_left(starts, start)]
                                     for start, end in ranges) / 1e3]
            for stage, ranges in spans.items()}


def run_profile(torch, cfg, device, tier="bfloat16", n_tok: int = 16) -> bool:
    """Where the slice's time goes (at `tier`): one round at full width with an n_tok-token
    image loop under torch.profiler, each stage in a profiler range. Prints the
    device (kernel) ms of each stage (llm_forward includes the prefill's
    forward; llm_decode_step is the rest per step; ranges nest, so the stages
    do not sum to the busy time), the device busy time against
    the wall clock, device events per image token, and the top kernels; then
    the same round unprofiled, for its wall clock."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile, record_function

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.engine import generate, session

    params = full_model(torch, cfg, device, tier)
    prompt = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, prompt[0], device)
    igen = dataclasses.replace(cfg.image_gen, num_image_tokens=n_tok)
    _generate(torch, params, cfg, RuntimeConfig(), device, prompt, igen)  # warm-up round
    modules = {"generate": generate, "session": session}
    saved = {stage: getattr(modules[mod], attr) for stage, (mod, attr) in STAGES.items()}

    def ranged(stage, fn):
        def call(*args, **kwargs):
            with record_function(stage):
                return fn(*args, **kwargs)
        return call

    for stage, (mod, attr) in STAGES.items():
        setattr(modules[mod], attr, ranged(stage, saved[stage]))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out, sess, wall_s = _generate(torch, params, cfg, RuntimeConfig(), device, prompt, igen)
    finally:
        for stage, (mod, attr) in STAGES.items():
            setattr(modules[mod], attr, saved[stage])
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda]
    by_stage = stage_device_ms(device_events)
    device_events = [e for e in device_events if e.name not in STAGES]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    (n_llm, llm_ms), prefill_ms = by_stage["llm_forward"], by_stage["prefill"][1]
    t = sess.timings
    print(f"profile ({tier} slice, {n_tok} image tokens, profiled): wall_s={wall_s:.3f} device_busy_ms={busy_ms:.1f} "
          f"busy_share={busy_ms / (wall_s * 1e3):.3f} device_events={len(device_events)} "
          f"per_image_token={len(device_events) / n_tok:.0f} prefill_ms={t['prefill_ms']:.2f} "
          f"image_loop_ms={t['image_loop_ms']:.1f} pixel_decode_ms={t['pixel_decode_ms']:.2f}")
    print("profile device ms by stage [calls, ms, ms/call]: " + "; ".join(
        f"{stage} [{n}, {ms:.3f}, {ms / max(n, 1):.3f}]" for stage, (n, ms) in by_stage.items())
        + f"; llm_decode_step [{n_llm - 1}, {llm_ms - prefill_ms:.3f}, {(llm_ms - prefill_ms) / max(n_llm - 1, 1):.3f}]")
    kernels = [e for e in prof.key_averages() if e.device_type == cuda and e.key not in STAGES]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile kernel: {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d} calls "
              f"{e.self_device_time_total / max(e.count, 1):9.3f} us/call  {e.key[:90]}")
    _, sess, wall_s = _generate(torch, params, cfg, RuntimeConfig(), device, prompt, igen)
    t = sess.timings
    print(f"profile (same round, unprofiled): wall_s={wall_s:.3f} prefill_ms={t['prefill_ms']:.2f} "
          f"image_loop_ms={t['image_loop_ms']:.1f} ms_per_image_step={t['image_loop_ms'] / n_tok:.3f} "
          f"pixel_decode_ms={t['pixel_decode_ms']:.2f}")
    return len(out.images) == 1 and busy_ms > 0


# the understanding round's stages: stage -> (module under engine/ or the session class, attribute)
UNDERSTAND_STAGES = {"encode": ("MingUniVisionSession", "extract_image_features"), "prefill": ("session", "prefill"),
                     "text_decode": ("session", "decode_text")}


def run_profile_understand(torch, cfg, device, tier="bfloat16", new_tokens: int = 8) -> bool:
    """Where the understanding round's time goes (at `tier`, attention outputs
    damped as in the `understand` phase): one round with `new_tokens` text
    tokens under torch.profiler, the encode, prefill and text-decode stages in
    profiler ranges. Prints each stage's device (kernel) ms, the device busy
    time against the wall clock, and the top kernels; a warm-up round first."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.engine import generate, session

    params = full_model(torch, cfg, device, tier)
    steer_text_head(params, cfg)
    damp_attention_outputs(params)
    prompt, pixels = image_prompt(cfg, 1024, 28, seed=21), pixel_values(1024, seed=22)
    kw = dict(pixels=pixels, max_new_tokens=new_tokens)
    _generate(torch, params, cfg, RuntimeConfig(), device, prompt, **kw)  # warm-up round
    owners = {"generate": generate, "session": session, "MingUniVisionSession": session.MingUniVisionSession}
    saved = {stage: getattr(owners[mod], attr) for stage, (mod, attr) in UNDERSTAND_STAGES.items()}

    def ranged(stage, fn):
        def call(*args, **kwargs):
            with record_function(stage):
                return fn(*args, **kwargs)
        return call

    for stage, (mod, attr) in UNDERSTAND_STAGES.items():
        setattr(owners[mod], attr, ranged(stage, saved[stage]))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out, sess, wall_s = _generate(torch, params, cfg, RuntimeConfig(), device, prompt, **kw)
    finally:
        for stage, (mod, attr) in UNDERSTAND_STAGES.items():
            setattr(owners[mod], attr, saved[stage])
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda]
    by_stage = stage_device_ms(device_events, UNDERSTAND_STAGES)
    device_events = [e for e in device_events if e.name not in UNDERSTAND_STAGES]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    t = sess.timings
    print(f"profile_understand ({tier}, {new_tokens} text tokens, profiled): wall_s={wall_s:.3f} "
          f"device_busy_ms={busy_ms:.1f} busy_share={busy_ms / (wall_s * 1e3):.3f} device_events={len(device_events)} "
          f"encode_ms={t['encode_ms']:.2f} prefill_ms={t['prefill_ms']:.2f} text_decode_ms={t['text_decode_ms']:.1f}")
    print("profile_understand device ms by stage [calls, ms]: " + "; ".join(
        f"{stage} [{n}, {ms:.3f}]" for stage, (n, ms) in by_stage.items()))
    kernels = [e for e in prof.key_averages() if e.device_type == cuda and e.key not in UNDERSTAND_STAGES]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile_understand kernel: {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d} calls "
              f"{e.self_device_time_total / max(e.count, 1):9.3f} us/call  {e.key[:90]}")
    return len(out.token_ids) == new_tokens and busy_ms > 0


def kernel_entry(name: str, r: dict, capacity: dict) -> dict:
    """One kernel's entry of the JSON line, from what this run measured:
    `launches` from the main path that runs it (its tier's T2I slice; the
    understanding round for flash prefill; one reconstruction batch for flash
    ViT; null when that path did not run) and `launches_by_path` from every
    path driven, the worst `max_abs_err` over the kernels phase's cases, and
    `ms`, `plain_ms`, `library_ms`, `bound_ms`, `bound_by` at that path's own
    shape (the first case); then every case."""
    source, replaces = KERNELS[name]
    cases = r.get("cases", [])
    first = cases[0] if cases else {}
    return {"name": name, "route": "cuda", "source": f"mingunivision_tpu_torch/{source}", "replaces": replaces,
            "launches": r.get("launches"), "max_abs_err": max((c["max_abs_err"] for c in cases), default=None),
            **{key: first.get(key) for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "launches_by_path": r.get("launches_by_path", {}),
            # of which through the capacity-dense dispatch (the prefill MoE kernels only)
            **({"capacity_dispatch_launches_by_path": capacity} if name.startswith("moe_swiglu_gmm") else {}),
            "cases": cases}


def jax_modules():
    """Loaded modules of JAX or of the JAX package, by exact name (the port's own
    package `mingunivision_tpu_torch` does not count)."""
    return sorted(m for m in sys.modules
                  if any(m == top or m.startswith(top + ".") for top in ("jax", "jaxlib", "mingunivision_tpu")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,build,kernels,reference,slice,slice_int4,understand,edit,recon")
    ap.add_argument("--tier", default="bfloat16", choices=("bfloat16", "int4"),
                    help="the tier of the profile, profile_understand and routing phases")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: torch.cuda.is_available() is False")
    if not os.path.isdir(os.path.join(ROOT, "mingunivision_tpu_torch")):
        return fail("mingunivision_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(smi.stdout.strip().splitlines()[0])
    print(f"device: {kind} x{torch.cuda.device_count()} | torch {torch.__version__} cuda {torch.version.cuda} | tf32 off")

    # 2. build
    from mingunivision_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    try:
        build.load()
    except RuntimeError as e:
        return fail(f"kernel build: {e}")
    print(f"build: {os.path.relpath(build.build_info['path'], ROOT)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info['seconds']:.2f} s, cached={build.build_info['cached']}; "
          f"RF sampler grid {build.load().mu_rf_sampler_grid()} CTAs)")

    from mingunivision_tpu_torch.config import MingUniVisionConfig

    cuda = torch.device("cuda")
    results: dict = {}
    ok = True
    if "kernels" in phases:
        ok &= check_kernels(torch, results)
    if "reference" in phases:
        ok &= run_reference(torch, cuda)
        ok &= run_reference(torch, cuda, "int4")
        ok &= run_reference_image(torch, cuda)
        ok &= run_reference_image(torch, cuda, "int4")
    if "divergence" in phases:
        ok &= run_divergence(torch, cuda)
    if "rf_sensitivity" in phases:
        ok &= run_rf_sensitivity(torch)
    if "recon" in phases:
        ok &= run_recon(torch, MingUniVisionConfig(), cuda, results)
    for tier, slice_phase in (("bfloat16", "slice"), ("int4", "slice_int4")):
        if not phases & {slice_phase, "understand", "edit"}:
            continue
        cfg = MingUniVisionConfig()
        params = full_model(torch, cfg, cuda, tier)  # built once for the tier's phases
        if slice_phase in phases:
            ok &= run_slice(torch, cfg, params, cuda, results, tier)
        if "edit" in phases:
            ok &= run_edit(torch, cfg, params, cuda, results, tier)
        if "understand" in phases:  # last: it steers the LM head towards text
            ok &= run_understand(torch, cfg, params, cuda, results, tier)
        del params
        torch.cuda.empty_cache()
    if "routing" in phases:
        ok &= run_routing(torch, MingUniVisionConfig(), cuda, args.tier)
    if "profile" in phases:
        ok &= run_profile(torch, MingUniVisionConfig(), cuda, args.tier)
    if "profile_understand" in phases:
        ok &= run_profile_understand(torch, MingUniVisionConfig(), cuda, args.tier)
    if jax_modules():
        return fail(f"JAX or the JAX package was imported: {jax_modules()}")
    if not ok:
        return fail("a phase failed (see above)")
    capacity = results.get("moe_capacity", {}).get("launches_by_path", {})
    print(json.dumps({"kernels": [kernel_entry(name, results.get(name, {}), capacity) for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
