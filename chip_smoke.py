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
              one), and the least time the card could take (bound)
  4. reference  a small model on the card, bf16 and then int4, through the
              kernels (bf16 compute) against the plain versions in fp32: same
              tokens; the step-0 hidden state and first RF latent within
              twice the plain bf16 path's own error (+1e-2 of their maximum);
              the image of the right shape, finite, in [-1, 1]
  5. slice    single-image text-to-image through MingUniVisionSession.generate
              at the full 16B-A3B width (random weights from a seed, bf16,
              max_seq_len 4096): output checks, launch counts of every kernel,
              prefill / image-loop / pixel-decode times, peak memory
  6. slice_int4  the same round with the LLM and RF head quantized to the
              int4 tier on the card (the serving tier): the int4 kernels'
              launch counts, times, resident and peak memory
Then a JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--phases` picks the phases (default: the six above). Three more run only when
named:
  divergence  the small model's plain bf16 path with each kernel swapped in
              alone, and all three, against plain bf16 and fp32: semantic-token
              error at loop step 0 and over the loop, image error
  profile     the slice with a 16-token image loop under torch.profiler:
              device ms per stage, device busy share, device events per token,
              top kernels; then the same round unprofiled (`--tier int4` for
              the int4 slice)
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


def run_case(torch, results, name, label, kern, plain, nbytes, ops, kind, library=None, iters=20) -> bool:
    """One kernel case: the kernel against its plain version on the same inputs,
    their median times (and the library call's), and the bound."""
    got = kern()
    torch.cuda.synchronize()
    ok, err, rel = compare(torch, got, plain())
    ms, plain_ms = cuda_ms(torch, kern, iters), cuda_ms(torch, plain, iters)
    library_ms = cuda_ms(torch, library, iters) if library is not None else None
    bound_ms, bound_by = bound(nbytes, ops, kind)
    lib = f" library_ms={library_ms:.4f}" if library_ms is not None else ""
    print(f"kernel {name} [{label}]: max_abs_err={err:.3e} rel_to_max={rel:.3e} tol_rel={REL_TOL} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}{lib} bound_ms={bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} G{'FLOP' if kind == 'bf16' else 'OP ' + kind}) {'ok' if ok else 'MISMATCH'}")
    results.setdefault(name, {}).setdefault("cases", []).append(
        {"shape": label, "max_abs_err": err, "rel_to_max": rel, "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by})
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


def bias_to_image_start(torch, params, cfg, ids, device):
    """Bias the lm_head column of <image> so that greedy decoding picks it after
    the prompt, as the engine tests do. The column is set to +-10 (in an int4
    table: nibbles +-7 at scale 10/7): a probe prefill of the prompt picks the
    sign that makes its logit large and positive."""
    from mingunivision_tpu_torch.engine.generate import prefill
    from mingunivision_tpu_torch.models.bailing_moe import LLMCache, embed_tokens
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
    cache = LLMCache.create(cfg.llm, 1, 128, torch.bfloat16, device)
    mask = torch.zeros((1, 128), dtype=torch.bool, device=device)
    mask[:, :T] = True
    ids_pad = torch.zeros((1, 128), dtype=torch.long, device=device)
    ids_pad[:, :T] = torch.as_tensor(ids, device=device)
    embeds = embed_tokens(params["llm"], ids_pad).to(torch.bfloat16)
    logits, _ = prefill(params["llm"], cfg.llm, embeds, cache, mask)
    if float(logits[0, img]) < 0:
        set_column(-1)


def randomize_adaln(params, generator):
    """Draw the RF head's zero-initialised AdaLN and final layers at std 0.02, so
    the sampled latents, and so the image, depend on the LLM's hidden states."""
    rf = params["rf_head"]
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.02, generator=generator)


def _generate(torch, params, cfg, runtime, device, prompt, image_gen=None):
    """One T2I round through the port's session; returns (output, session, seconds)."""
    from mingunivision_tpu_torch.config import GenerationConfig
    from mingunivision_tpu_torch.engine.session import MingUniVisionSession

    ids, am, um, tm = prompt
    sess = MingUniVisionSession(params, cfg, runtime, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sess.generate(ids, am, uncond_attention_mask=um, text_uncond_attention_mask=tm,
                        generation=GenerationConfig(max_new_tokens=1), image_gen=image_gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, sess, time.perf_counter() - t0


def image_checks(out, sess, cfg, T, size):
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
               ("2 CFG rows", sess.timings.get("cfg_rows") == 2)]
    return checks


# the model-level entry points the main paths call the kernels by (the MoE
# entries dispatch bf16 and int4 tables to their kernels themselves)
ENTRIES = ("moe_stream", "moe_swiglu_gmm", "decode_attention", "rf_sampler")


@contextlib.contextmanager
def plain_versions(names=ENTRIES):
    """Route the main path's calls of the named entry points to their plain
    versions for the block (the names the model modules call them by are patched)."""
    from mingunivision_tpu_torch.models import bailing_moe as bm
    from mingunivision_tpu_torch.models import rf_head
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_plain
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_plain
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused_plain

    swaps = {"moe_stream": (bm, "moe_experts_stream", moe_experts_stream_plain),
             "moe_swiglu_gmm": (bm, "moe_experts_swiglu_gmm", moe_experts_swiglu_gmm_plain),
             "decode_attention": (bm, "decode_attention", decode_attention_plain),
             "rf_sampler": (rf_head, "rf_sample_fused", rf_sample_fused_plain)}
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
    """Random bf16 weights of `cfg` on the device from seed 0, and the prompt;
    for `tier` "int4" the LLM and RF head are then quantized in place on the
    device, leaf by leaf. Returns (params, prompt)."""
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
    prompt = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, prompt[0], device)
    return params, prompt


def launch_counters():
    """kernel name -> the wrapper that counts its launches."""
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream, moe_experts_stream_q4s8
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_q4
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused

    return {"moe_stream": moe_experts_stream, "moe_swiglu_gmm": moe_experts_swiglu_gmm,
            "decode_attention": decode_attention, "moe_stream_q4s8": moe_experts_stream_q4s8,
            "moe_swiglu_gmm_q4": moe_experts_swiglu_gmm_q4, "rf_sampler_q4s8": rf_sample_fused}


def run_slice(torch, cfg, device, results: dict, tier="bfloat16") -> bool:
    """One full-width T2I round at `tier`, with every kernel's launch count read
    around it; the kernels of the tier's path must reach their floors (per LLM
    step and layer for the decode kernels, per layer for the prefill one, per
    image token for the RF sampler) and the others must not launch."""
    from mingunivision_tpu_torch.config import RuntimeConfig

    L = cfg.llm.num_hidden_layers
    n_tok = cfg.image_gen.num_image_tokens
    params, prompt = full_model(torch, cfg, device, tier)
    resident = torch.cuda.memory_allocated()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out, sess, total_s = _generate(torch, params, cfg, RuntimeConfig(), device, prompt)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()

    T = prompt[0].shape[1]
    if tier == "bfloat16":
        floors = {"moe_stream": L * (n_tok + 1), "moe_swiglu_gmm": L, "decode_attention": L * (n_tok + 1)}
    else:
        floors = {"moe_stream_q4s8": L * (n_tok + 1), "moe_swiglu_gmm_q4": L, "decode_attention": L * (n_tok + 1),
                  "rf_sampler_q4s8": n_tok}
    checks = image_checks(out, sess, cfg, T, 512)
    checks += [(f"{name} launches {launches[name]} >= {floor}", launches[name] >= floor) for name, floor in floors.items()]
    checks += [(f"{name} launches {n} == 0", n == 0) for name, n in launches.items() if name not in floors]
    t = sess.timings
    label = "slice" if tier == "bfloat16" else f"slice_{tier}"
    print(f"{label} T2I: prompt {T} ids (bucket 128), {L} layers, {tier}, cfg_rows={t.get('cfg_rows')}, "
          f"prefill_ms={t['prefill_ms']:.2f} image_loop_ms={t['image_loop_ms']:.1f} "
          f"ms_per_ar_token={t['image_loop_ms'] / n_tok:.3f} pixel_decode_ms={t['pixel_decode_ms']:.2f} "
          f"total_s={total_s:.3f} resident_gib={resident / 2**30:.3f} max_memory_allocated_gib={peak / 2**30:.3f}")
    print(f"{label} launches: " + ", ".join(f"{name}={n}" for name, n in launches.items()))
    print(f"{label} checks: " + "; ".join(f"{lab}={'ok' if p else 'FAILED'}" for lab, p in checks))
    for name in floors:
        results.setdefault(name, {})["launches"] = launches[name]
    return all(p for _, p in checks)


# stage -> (module under engine/, the name the round calls the stage by there)
STAGES = {"prefill": ("session", "prefill"), "llm_forward": ("generate", "bailing_forward"),
          "vis_head": ("generate", "vis_head_apply"), "rf_sample": ("generate", "rf_sample"),
          "semdec_step": ("generate", "mingtok_feature_decoder"), "linear_proj": ("generate", "linear_proj_apply"),
          "pixel_decoder": ("generate", "mingtok_pixel_decoder")}


def stage_device_ms(device_events) -> dict:
    """stage -> [calls, device ms of the events inside the stage's ranges on the
    device timeline]. A range's device span runs from its first to its last
    kernel; the kernels built in csrc/ launch through ctypes, with no PyTorch
    op to hang them on in the host-side tree, so they are placed by time."""
    import bisect
    import itertools

    spans = {stage: [] for stage in STAGES}
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

    params, prompt = full_model(torch, cfg, device, tier)
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


def kernel_entry(name: str, r: dict) -> dict:
    """One kernel's entry of the JSON line, from what this run measured:
    `launches` from its main path's slice phase (null when it did not run),
    the worst `max_abs_err` over the kernels phase's cases, and `ms`,
    `plain_ms`, `library_ms`, `bound_ms`, `bound_by` at the slice's own shape
    (the first case); then every case."""
    source, replaces = KERNELS[name]
    cases = r.get("cases", [])
    first = cases[0] if cases else {}
    return {"name": name, "route": "cuda", "source": f"mingunivision_tpu_torch/{source}", "replaces": replaces,
            "launches": r.get("launches"), "max_abs_err": max((c["max_abs_err"] for c in cases), default=None),
            **{key: first.get(key) for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cases": cases}


def jax_modules():
    """Loaded modules of JAX or of the JAX package, by exact name (the port's own
    package `mingunivision_tpu_torch` does not count)."""
    return sorted(m for m in sys.modules
                  if any(m == top or m.startswith(top + ".") for top in ("jax", "jaxlib", "mingunivision_tpu")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,build,kernels,reference,slice,slice_int4")
    ap.add_argument("--tier", default="bfloat16", choices=("bfloat16", "int4"), help="the profile phase's tier")
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
    if "divergence" in phases:
        ok &= run_divergence(torch, cuda)
    if "rf_sensitivity" in phases:
        ok &= run_rf_sensitivity(torch)
    if "slice" in phases:
        ok &= run_slice(torch, MingUniVisionConfig(), cuda, results)
    if "slice_int4" in phases:
        ok &= run_slice(torch, MingUniVisionConfig(), cuda, results, "int4")
    if "profile" in phases:
        ok &= run_profile(torch, MingUniVisionConfig(), cuda, args.tier)
    if jax_modules():
        return fail(f"JAX or the JAX package was imported: {jax_modules()}")
    if not ok:
        return fail("a phase failed (see above)")
    print(json.dumps({"kernels": [kernel_entry(name, results.get(name, {})) for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
