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
              the understanding prompt's 1,152 tokens, beside the expert-sorted
              one; every kernel of the bf16, int4 and int8 tiers in every
              dot mode (the int4 and int8 decode MoE with s8 dots and exact
              dequant, the int4 and int8 prefill MoE exact and with s8 dots,
              the int8 sampler exact and with s8 dots); the per-step RF stack
              in its four bodies (one Euler step at full width, 2 and 3 rows),
              the int4 sampler's pipelined schedule beside its block one, and
              the full-expert-block prefill MoE (int4: 128 tokens, skewed,
              1,152; int8: 128 tokens); the RF kernels to the bit; the
              grouped matmuls of MoE training (gmm, gmm_trhs, tgmm) at the
              train step's 12,288 rows, uniform and skewed with empty experts
              and a padded last group (gmm and gmm_trhs: the body each case
              takes, its kernel-alone device time (`kernel_device_ms`) beside
              the wrapper's, and the mma_sync body timed beside the wgmma one;
              one odd-width case on the mma_sync body), and the
              differentiable fused prefill MoE at full width, its forward and
              every grad; decode attention (the split-S kernel) at the
              table's 1,072-position case and at the image loop's 300-position
              prefix at 2, 3 and 12 rows, with its kernel-alone device time;
              the ViT flash forward at the pixel decoder's 16 heads x 1,024
              tokens x 64 at 1, 2 and 8 images, with and without residuals
              (output and log-sum-exp), on its wgmma body, kernel-alone too; its two
              backward kernels (dK / dV, dQ) at batch 2 and 8, beside SDPA's
              backward; the
              gathered-expert matmul at the pool's decode shapes (12-72
              assignments, skewed) beside torch._grouped_mm, and the decode
              MoE built on it held against the decode-MoE kernel; the bf16
              decode MoE and the int4 one with s8 dots (held to the bit) at
              1, 2, 3, 12 and 16 rows and paged decode attention at batch 1,
              8 and 16, each with its kernel-alone device time, its device
              events per call (at most 2, 2 and 1: nothing but its kernels)
              and one allocation per call (the output); the same three for
              the int8 decode MoE with s8 dots (held to the bit) and the
              int4 one with exact dequant at their cases
  4. reference  a small model on the card, bf16, int4 (as shipped and with
              moe_int_dots=False), int8 (as shipped and with
              moe_prefill_int_dots and rf_int_dots on) and NF4 (and, on the
              card only, the per-step RF route, rf_fused_sampler=False, at
              int4 and int8 in the four bodies of its stack), through the
              kernels (bf16 compute) against the plain versions in fp32: same
              tokens; every LLM kernel entry (decode MoE, prefill MoE through
              either dispatch, decode attention) held at every call against
              its plain version on the same inputs, within REL_TOL; the
              step-0 hidden state and first RF latent within
              twice the plain bf16 path's own error (+1e-2 of their maximum);
              the image of the right shape, finite, in [-1, 1]. Then the same
              on an image prompt that pads to 512 tokens (flash prefill, the
              capacity dispatch, text decode): same tokens, the prefill's
              last-position hidden state within the same bound. Then the
              small model's paged serving engine on 4 slots with mid-flight
              admission: same tokens, each request's first-step logits within
              the same bound. Then the small model's lm_loss backward (one
              layer): the loss and every grad within the same bound, every
              training kernel call held against its plain version; then a
              small MingTok's mingtok_train_loss backward (the pixel decoder
              on 1,024 tokens) at "bf16", and with remat at "default", the
              same way, every flash forward and backward call held; then
              the small model's image pool (3 slots, a request admitted
              mid-loop, per-slot text_cfg 1 / 3 / 9) at bf16 and int4, every
              LLM kernel entry and the fused sampler held at every call, the
              sampler launched once per active slot and micro-step, the
              gathered-expert matmul held in context on one captured pool
              step's decode-MoE inputs
 4b. train    training at the 16B-A3B width cut to 4 decoder layers: the LM
              train step (B 2 x T 1024 of a synthetic token stream, AdamW at
              1e-3, router aux losses; a warm-up step and 3 timed steps on the
              same batch: the loss must fall), then the image-generation step
              (32 text ids + 256 image positions, the full RF head, 2 steps):
              losses, ms per step, tokens/s, resident and peak memory, one
              profiled LM step's device time by kernel and the grouped
              matmuls' share, the routing the step's grouped matmuls see,
              launches (per layer and step: the fused prefill MoE 1, gmm 3,
              gmm_trhs 3, tgmm 3, every gmm and gmm_trhs on the wgmma body)
 4c. train_mingtok  MingTok joint training as examples/train_mingtok.py runs
              it: the full MingTokConfig() (0.7 B params, bf16), B 2 x 512 px
              of the synthetic image stream, teacher features, AdamW 1e-4;
              the pixel decoder's "bf16" tier (4 steps: the loss must fall),
              "bf16" with remat, "default" and "high" (2 steps each): losses,
              ms per step, images/s, memory, launches per step (the flash
              forward 24, 48 with remat, each on the wgmma body, dK / dV 24,
              dQ 24; none at "high"), one profiled "bf16" step
  5. slice    single-image text-to-image through MingUniVisionSession.generate
              at the full 16B-A3B width (random weights from a seed, bf16,
              max_seq_len 4096): output checks, launch counts of every kernel,
              prefill / image-loop / pixel-decode times, peak memory
  6. slice_int4  the same round with the LLM and RF head quantized to the
              int4 tier on the card (the serving tier): the int4 kernels'
              launch counts, times, resident and peak memory
     slice_int4_rf8  the same round on the mixed tier (RuntimeConfig
              param_dtype "int4", rf_param_dtype "int8"): the int4 model with
              its RF head swapped for an int8 one, quantized on the card from a
              bf16 copy kept aside; the int4 LLM kernels and the int8 sampler
     slice_int4_exact  the int4 model's round with moe_int_dots=False: the
              exact-dequant int4 decode MoE (this, the mixed tier's round, the
              n_images=2 round and the other rounds in another dot mode or RF
              route below cut to 64 image tokens, a 256-px image, to keep the
              run in its limit)
     slice_int8  the same round on the int8 quality tier (LLM and RF head int8):
              the int8 decode MoE with s8 dots, the int8 prefill MoE, the int8
              sampler
     slice_int8_s8  the int8 model's round with rf_int_dots=True: the int8
              sampler with s8 dots
     slice_int4_perstep, slice_int8_perstep  the int4 and int8 models' rounds
              with rf_fused_sampler=False: the Euler steps through the per-step
              stack kernel (s8 dots at int4, exact at int8, the JAX package's
              defaults), one launch per step, none of the fused sampler
     slice_nf4  the same round on the NF4 tier (RuntimeConfig param_dtype
              "int4-nf4", quantized on the card): plain-dequant MoE entries and
              the RF head's Euler loop, no quantized kernel; its loop cut to
              64 image tokens (a 256-px image) to keep the run in its limit
     images_int4  T2I with n_images=2 through the session on the int4 model:
              4 rows in one loop, one sampler launch per token
     image_batch_int4  the barrier batcher: 3 prompts of 37 / 90 / 200 ids,
              9 rows, one sampler launch per image and token
     image_pool_int4  ImagePoolWorker over ImagePoolEngine(slots=4,
              chunk=32): 2 requests, 2 more after 64 micro-steps, text_cfg
              3 / 3 / 1 / 5, seeds 0-3; ms per micro-step at 2 and 4 active
              slots, images per minute, launches per micro-step, pool KV bytes
  7. understand  image -> text on each tier's full-width model: a 1024-px image
              (1,024 patch tokens, the prompt pads to 1,152) through the
              MingTok encoder, flash prefill and the capacity MoE dispatch
              (the random model's attention outputs damped first, or every
              image row would route to the same experts and overflow it), then
              32 greedy text tokens; launch counts, capacity fallbacks, encode
              / prefill / per-text-token times, peak memory; at int4 and int8
              once more with moe_prefill_int_dots=True (the s8 prefill
              kernels), and at int8 with moe_int_dots=False (the exact-dequant
              decode kernel)
  8. edit     image + edit request -> image on each tier's model: a 512-px image
              (256 patch tokens, the prompt pads to 384), the 256-token image
              loop with 3 CFG rows; launch counts, ms per AR token
  9. recon    MingTok reconstruction (encode -> pixel decode) at 512 px, batch
              1 and 8, on the pixel decoder's "high", "default" and "bf16"
              tiers: flash-ViT launches (each on the wgmma body), PSNR of the
              reduced tiers against "high", ms per image
 10. serve    continuous-batching text serving on each tier's model: 24
              requests (12 sharing a 256-id system prefix, 4 sampled) from 4
              client threads in 3 waves through InferenceServer's
              BatchTextWorker on the paged pool (16 slots, max_len 2048, page
              64, prefix cache), then the same requests on the dense pool;
              then the greedy ones on both pools with the same attention
              arithmetic (the plain versions, every kernel call held against
              them): the tokens must be equal, request by request; then a
              starved paged pool (40 pages) that must stall and resume;
              tokens/s, ms per engine step at 1, 4, 8 and 16 active slots,
              time to first token, prefix hits, stalls, launches per step,
              pool and peak memory
A tier's model is built once and serves its slice, edit, understand and serve
phases (bf16 and int4 serve; the int8 tier runs no serving round; the NF4
tier only its T2I round).
Then a JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--phases` picks the phases (default: the twenty-two above), e.g.
`--phases device,build,kernels,understand` or `--phases device,build,kernels,serve`. Ten more run only when named:
  decode_kernels  the kernels phase's cases of the decode kernels that run
              without a PyTorch op: the bf16 decode MoE, the int4 one in both
              dot modes, the int8 one with s8 dots and paged decode attention
              at their main paths' shapes,
              each with its kernel-alone device time and its kernels per call
              (the way to time an older tree's kernels beside these: run this
              script from that tree's root)
  prefill_kernels  the prefill MoE on bf16 tables (row 2), on int4 tables
              (row 5) and on int8 tables (row 7c), both with exact dequant, at
              full width: 128 tokens, the same skewed to 8 experts, 384, 1,152
              (92 pads) through the sorted and the capacity dispatch, and row 2
              at the LM train step's 2,048 tokens (12,288 rows): through the
              wrapper, the kernels alone over the prepared schedule
              (`kernel_device_ms`), bound, device events and allocations per
              call, max abs error; row 2 beside a yardstick of three PyTorch
              calls (`torch._grouped_mm` for W1 and W3, silu * mul, the down
              `_grouped_mm`); then the flash prefill at the understanding
              prompt's 1 x 1,152 x 16 / 4 x 128, with 92 pads and with none,
              alone, beside SDPA (is_causal=True, enable_gqa=True without
              pads; the boolean mask in both cases), alone too; runs from an
              older tree's root too, as decode_kernels
  sampler_kernels  the fused RF samplers at full width, 2 CFG rows and 3
              with renorm: the int4 one in both schedules, the int8 one in
              both dot modes, held to the bit, with their kernel-alone device
              times with the tables warm and cold (run from an older tree's
              root, as decode_kernels, to time that tree's)
  stack_kernels  the per-step RF stack in its four bodies at full width (one
              Euler step, 2 and 3 rows, held to the bit) and the
              gathered-expert matmul at the pool's decode shapes (12-72
              assignments, the down table, 72 on two experts) beside
              torch._grouped_mm: each through its wrapper, alone
              (`kernel_device_ms`, and the kernel's own device time from the
              profiler), with its bound and device events per call (run from
              an older tree's root, as decode_kernels, to time that tree's)
  divergence  the small model's plain bf16 path with each kernel swapped in
              alone, and all of them, and with the image head's input moved
              by one bf16 ulp, against plain bf16 and fp32 (`--tier`):
              hidden-state, first-latent and semantic-token error at loop step
              0 and over the loop, image error
  profile     the slice with a 16-token image loop under torch.profiler:
              device ms per stage, device busy share, device events per token,
              top kernels, decode attention's and the decode MoE's device ms
              per LLM step, the RF head's per image token; then the
              same round unprofiled (`--tier int4` or
              `--tier int8` for the quantized slices; `--rf-per-step` for the
              RF head through the per-step stack, rf_fused_sampler=False)
  profile_understand  the understanding round with 8 text tokens under
              torch.profiler: device ms of the encode, prefill and text-decode
              stages, busy share, top kernels (`--tier`)
  serve_check  where the two serving pools part (bf16): the serve traffic on
              the paged pool, then the dense pool fed its tokens, every
              attention and decode-MoE call held against its plain version;
              the forced-token margins
  routing     the understanding prompt's expert loads per layer on the
              full-width random model (`--tier`), as initialised and with the
              attention outputs damped, against the capacity of the dispatch
  rf_sensitivity  the int4 and int8 RF samplers at full width: each kernel
              against its plain version beside the plain version against
              itself under a 1-ulp change of its input, over 1 and 12 blocks
              and 1 and 16 steps; first, how often a CUDA division by a Python
              number misses the correctly rounded quotient
e.g. `python3 chip_smoke.py --phases device,build,divergence,profile`.
The nvcc/ptxas log (registers, shared memory, spills) lands beside the built
library, under mingunivision_tpu_torch/_build/.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
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
    # one kernel for both TPU entries: _paged_decode_kernel :74 (via pallas_paged_decode_attention :122) and
    # the library multi-page kernel behind paged_decode_attention_auto :189
    "paged_attention": ("csrc/paged_attention.cu", "mingunivision_tpu/ops/kernels/paged_attention.py:74"),
    # the int8 tier: one source for both decode dot modes (s8 dots by default, exact with moe_int_dots=False)
    "moe_stream_q8s8": ("csrc/moe_stream_q8.cu", "mingunivision_tpu/ops/kernels/moe_stream.py:142"),
    "moe_stream_q8": ("csrc/moe_stream_q8.cu", "mingunivision_tpu/ops/kernels/moe_stream.py:74"),
    "moe_swiglu_gmm_q8": ("csrc/moe_swiglu_gmm_q8.cu", "mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py:185"),
    "rf_sampler_q8": ("csrc/rf_sampler_q8.cu", "mingunivision_tpu/ops/kernels/rf_sampler.py:395"),
    # the other dot modes of the same sources: int4 decode with exact dequant (moe_int_dots=False), the s8
    # prefill MoE (moe_prefill_int_dots=True) and the int8 sampler's s8_dots branch (rf_int_dots=True)
    "moe_stream_q4": ("csrc/moe_stream_q4.cu", "mingunivision_tpu/ops/kernels/moe_stream.py:104"),
    "moe_swiglu_gmm_q8s8": ("csrc/moe_swiglu_gmm_q8.cu", "mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py:236"),
    "moe_swiglu_gmm_q4s8": ("csrc/moe_swiglu_gmm_q4.cu", "mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py:432"),
    "rf_sampler_q8s8": ("csrc/rf_sampler_q8.cu", "mingunivision_tpu/ops/kernels/rf_sampler.py:395"),
    # the per-step RF stack (RuntimeConfig(rf_fused_sampler=False)) in its four bodies, the stack mode of the fused
    # samplers' body: int4 with s8 dots (rf_int4_int_dots, on by default) in the int4 sampler's source; exact
    # dequant, int8 exact (rf_int_dots off) and with s8 dots in the int8 sampler's
    "rf_mlp_q4s8": ("csrc/rf_sampler_q4.cu", "mingunivision_tpu/ops/kernels/rf_mlp.py:326"),
    "rf_mlp_q4": ("csrc/rf_sampler_q8.cu", "mingunivision_tpu/ops/kernels/rf_mlp.py:243"),
    "rf_mlp_q8": ("csrc/rf_sampler_q8.cu", "mingunivision_tpu/ops/kernels/rf_mlp.py:39"),
    "rf_mlp_q8s8": ("csrc/rf_sampler_q8.cu", "mingunivision_tpu/ops/kernels/rf_mlp.py:168"),
    # explicit arguments no entry point passes, as in the JAX package: the int4 sampler's pipelined schedule
    # (rf_sample_fused(schedule="pipelined")) and the full-expert-block prefill (full_block=True) over int4 and
    # int8 tables, the two branches of one TPU kernel body
    "rf_sampler_q4s8_pipelined": ("csrc/rf_sampler_q4.cu", "mingunivision_tpu/ops/kernels/rf_sampler.py:126"),
    "moe_swiglu_gmm_q4_full": ("csrc/moe_swiglu_gmm_q4.cu", "mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py:115"),
    "moe_swiglu_gmm_q8_full": ("csrc/moe_swiglu_gmm_q4.cu", "mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py:115"),
    # the eighth slice: the library megablox kernels behind moe_experts_gmm (their call sites at :85-88; the
    # transposed gmm and tgmm are megablox's custom VJP of those calls, ops.py _gmm_bwd)
    "gmm": ("csrc/gmm.cu", "mingunivision_tpu/ops/kernels/moe_gmm.py:85"),
    "gmm_trhs": ("csrc/gmm.cu", "mingunivision_tpu/ops/kernels/moe_gmm.py:85"),
    "tgmm": ("csrc/gmm.cu", "mingunivision_tpu/ops/kernels/moe_gmm.py:85"),
    # the ninth slice: the backward kernels of the library flash attention (its custom VJP,
    # flash_attention.py _flash_attention_bwd_dkv :941 and _flash_attention_bwd_dq :1287) behind the ViT
    # entry's call, reached by MingTok training
    "flash_vit_bwd_dkv": ("csrc/flash_attention.cu", "mingunivision_tpu/ops/kernels/flash.py:90"),
    "flash_vit_bwd_dq": ("csrc/flash_attention.cu", "mingunivision_tpu/ops/kernels/flash.py:90"),
    # the tenth slice: the gathered-expert matmul (gathered_expert_matmul :42, pallas_call :75), which no entry
    # point of either package reaches: held on the pool's decode shapes and in context on captured pool inputs
    "gathered_expert_matmul": ("csrc/expert_matmul.cu", "mingunivision_tpu/ops/kernels/expert_matmul.py:33"),
}
# the kernels on a second design for the H100 (warp-specialized wgmma or mma.sync bodies fed by TMA or cp.async
# rings, split or persistent grids); the others are still their simple first versions
REDESIGNED = {"moe_stream", "moe_swiglu_gmm", "decode_attention", "moe_stream_q4s8", "moe_swiglu_gmm_q4",
              "rf_sampler_q4s8", "flash_prefill", "flash_vit", "paged_attention", "moe_stream_q8s8",
              "moe_swiglu_gmm_q8", "rf_sampler_q8", "moe_stream_q4", "rf_sampler_q8s8", "rf_sampler_q4s8_pipelined",
              "gmm", "gmm_trhs", "tgmm", "flash_vit_bwd_dkv", "flash_vit_bwd_dq", "rf_mlp_q4s8", "rf_mlp_q4",
              "rf_mlp_q8", "rf_mlp_q8s8"}
BF16_KERNELS = ("moe_stream", "moe_swiglu_gmm", "decode_attention")
NF4_IMAGE_TOKENS = 64  # the slice_nf4 round's image loop (256-304 ms per token), cut to keep the run in its limit
# the image loops of the rounds that rerun a tier's T2I in another dot mode, RF route or RF tier
# (slice_int4_exact, slice_int8_s8, slice_int4_perstep, slice_int8_perstep, slice_int4_rf8) and of the
# n_images=2 round (images_int4), cut to keep the run in its limit: each still launches its kernels at
# every LLM step and image token, held by the same floors
VARIANT_IMAGE_TOKENS = 64
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
    """(ok, max abs error, error relative to max |want|) of a kernel's output
    against its plain version; for a tuple of outputs, each part is held on
    its own and the worst part is reported."""
    if isinstance(got, (tuple, list)):
        parts = [compare(torch, a, b) for a, b in zip(got, want, strict=True)]
        return all(p[0] for p in parts), max(p[1] for p in parts), max(p[2] for p in parts)
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
             others=None, plain_iters=None, bitwise=False) -> bool:
    """One kernel case: the kernel against its plain version on the same inputs
    (on the rows of the boolean mask `rows` when given), their median times
    (and the library call's), and the bound. `others`: label -> a callable timed
    beside them and recorded in the case under `<label>_ms`. `plain_iters`: the
    plain version's timed runs (and warm-ups), where it takes seconds.
    `bitwise`: held to the bit (the kernels whose plain versions sum in their
    order), else within REL_TOL."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    ok, err, rel = compare(torch, got, want) if rows is None else compare(torch, got[rows], want[rows])
    ok = ok and (err == 0 or not bitwise)
    ms = cuda_ms(torch, kern, iters)
    plain_ms = cuda_ms(torch, plain, plain_iters or iters, warmup=min(3, plain_iters or iters))
    library_ms = cuda_ms(torch, library, iters) if library is not None else None
    other_ms = {f"{key}_ms": cuda_ms(torch, fn, iters) for key, fn in (others or {}).items()}
    bound_ms, bound_by = bound(nbytes, ops, kind)
    lib = f" library_ms={library_ms:.4f}" if library_ms is not None else ""
    lib += "".join(f" {key}={val:.4f}" for key, val in other_ms.items())
    print(f"kernel {name} [{label}]: max_abs_err={err:.3e} rel_to_max={rel:.3e} tol_rel={0 if bitwise else REL_TOL} "
          f"ms={ms:.4f} "
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


def full_width_rf(torch, rf_cfg, generator, adaln_std: float, bits: int = 4):
    """The RF head at `rf_cfg`'s width on the card: random bf16 weights, the
    AdaLN and final layers drawn at `adaln_std`, quantized to `bits` in place."""
    from mingunivision_tpu_torch.utils.convert import _Init, init_rf_head_params
    from mingunivision_tpu_torch.utils.quantize import quantize_tree_inplace

    rf = init_rf_head_params(rf_cfg, _Init(torch.device("cuda"), torch.bfloat16, generator))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, adaln_std, generator=generator)
    return quantize_tree_inplace(rf, bits=bits)


def run_rf_sensitivity(torch) -> bool:
    """How far the int4 and int8 RF samplers' outputs move under a 1-ulp
    change, against how far each kernel lies from its plain version (after a
    count of how often PyTorch's CUDA division misses the correctly rounded
    quotient, the 1-ulp change the plain version once made): full width, 2 CFG
    rows, one block or all 12, one Euler step or all 16, AdaLN weights at std
    0.02 (the slice's) and 0.002. The ulp change multiplies every modulated-LN
    output of the plain version by 1 +- 2**-22 before its s8 quantization
    (int4) or its rounding to bf16 (int8)."""
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
    for bits, std in ((4, 0.02), (4, 0.002), (8, 0.02), (8, 0.002)):
        g = torch.Generator(device=dev).manual_seed(0)
        rf = full_width_rf(torch, rf_cfg, g, std, bits)
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
                print(f"rf_sensitivity [int{bits}, AdaLN std {std}, {L} block(s), {S} step(s)]: max|plain|="
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
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import (
        default_capacity,
        moe_experts_capacity_gmm,
        moe_experts_capacity_gmm_exact,
        moe_experts_capacity_gmm_exact_plain,
    )
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_plain, moe_experts_stream
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_plain
    from mingunivision_tpu_torch.ops.kernels.rf_mlp import rf_mlp_stack, rf_mlp_stack_plain
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import (
        MAX_ROWS,
        rf_sample_fused,
        rf_sample_fused_plain,
        rf_sample_fused_q8,
        rf_sample_fused_q8s8,
    )
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

    def capacity_cases(tables, name, per_expert_bytes, s8=False):
        """Kernel `name` launched through the capacity-dense dispatch at the
        understanding prompt's shape, beside the expert-sorted dispatch on the
        same routing: a natural routing (it fits the slots; padding rows kept
        out by token_valid) and one skewed to 8 experts (it overflows, and the
        sorted dispatch runs: a counted fallback). Valid rows are compared.
        s8: the quantized kernels' s8-dot mode (operations at the int8 rate)."""
        ok = True
        for label, choices, fits in ((f"capacity dispatch C={cap}: 1152 tok (92 pads) x k=6", None, True),
                                     ("capacity dispatch, skewed to 8 experts: overflow -> sorted fallback",
                                      [0, 5, 9, 17, 33, 34, 50, 63], False)):
            x = torch.randn((n_und, h), device=dev, generator=g).to(bf)
            idx, w = routing(n_und, choices)
            x[~und_valid], idx[~und_valid], w[~und_valid] = x[-1].clone(), idx[-1].clone(), w[-1].clone()
            launches, fallbacks = moe_experts_capacity_gmm.launches, moe_experts_capacity_gmm_exact.fallbacks
            args = (tables, x, idx, w, E, cap)
            kw = dict(token_valid=und_valid, layer_idx=0, s8=s8)
            nbytes, ops = moe_work(idx[und_valid], n_und, per_expert_bytes, 2)
            ok &= run_case(torch, results, name, label, lambda: moe_experts_capacity_gmm_exact(*args, **kw),  # noqa: B023
                           lambda: moe_experts_capacity_gmm_exact_plain(*args, **kw), nbytes, ops,  # noqa: B023
                           "int8" if s8 else "bf16", iters=5, rows=und_valid, plain_iters=2 if s8 else None,
                           others={"sorted_dispatch": lambda: moe_experts_swiglu_gmm(*args[:5], layer_idx=0,  # noqa: B023
                                                                                     s8=s8)})
            went = (moe_experts_capacity_gmm.launches > launches, moe_experts_capacity_gmm_exact.fallbacks > fallbacks)
            print(f"kernel {name} [{label}]: through the slots={went[0]} fell back={went[1]}")
            ok &= went == (fits, not fits)
            results[name]["cases"][-1].update(capacity=cap, fell_back=went[1])
        return ok

    # bf16 tables: 3 h m bf16 per routed expert
    all_ok &= decode_moe_cases(torch, results, experts, routing, g, h, m)
    for label, n, choices in prefill:
        x = torch.randn((n, h), device=dev, generator=g).to(bf)
        idx, w = routing(n, choices)
        nbytes, ops = moe_work(idx, n, 3 * h * m * 2, 2)
        all_ok &= run_case(torch, results, "moe_swiglu_gmm", label,
                           lambda: moe_experts_swiglu_gmm(experts, x, idx, w, E, layer_idx=0),  # noqa: B023
                           lambda: moe_experts_swiglu_gmm_plain(experts, x, idx, w, E, layer_idx=0),  # noqa: B023
                           nbytes, ops, "bf16")
    all_ok &= capacity_cases(experts, "moe_swiglu_gmm", 3 * h * m * 2)
    all_ok &= expert_matmul_cases(torch, results, experts, routing, g)

    def dot_mode_cases(tables, decode_name, prefill_name, per_expert_bytes):
        """The other dot mode of the quantized kernels: the exact-dequant decode
        MoE (`decode_name`, int4 tables) at 2 rows (its main path: the T2I round
        with moe_int_dots=False), 1, 3 and 16, each with its kernel-alone time,
        at most two kernels and one allocation a call; the s8-dot prefill MoE
        (`prefill_name`) first at its main path's shape, the understanding
        prompt's 1,152 tokens through the capacity dispatch (and its overflow),
        then at a 128-token prompt and one skewed to 8 experts."""
        ok = True
        if decode_name is not None:
            for label, n, choices in [decode[0], ("N=1 k=6 (understanding text decode)", 1, None),
                                      ("N=3 k=6 (editing decode)", 3, None), decode[1]]:
                x = torch.randn((n, h), device=dev, generator=g).to(bf)
                idx, w = routing(n, choices)
                nbytes, ops = moe_work(idx, n, per_expert_bytes, 2)
                kern = lambda: moe_experts_stream(tables, x, idx, w, layer_idx=0, int_dots=False)  # noqa: B023, E731
                ok &= run_case(torch, results, decode_name, label, kern,
                               lambda: moe_experts_stream_plain(tables, x, idx, w, layer_idx=0,  # noqa: B023
                                                                int_dots=False), nbytes, ops, "bf16")
                ok &= one_launch_checks(torch, results, decode_name, kern, kernels=2)
        ok &= capacity_cases(tables, prefill_name, per_expert_bytes, s8=True)
        for label, n, choices in prefill:
            x = torch.randn((n, h), device=dev, generator=g).to(bf)
            idx, w = routing(n, choices)
            nbytes, ops = moe_work(idx, n, per_expert_bytes, 2)
            ok &= run_case(torch, results, prefill_name, label,
                           lambda: moe_experts_swiglu_gmm(tables, x, idx, w, E, layer_idx=0, s8=True),  # noqa: B023
                           lambda: moe_experts_swiglu_gmm_plain(tables, x, idx, w, E, layer_idx=0,  # noqa: B023
                                                                s8=True), nbytes, ops, "int8", plain_iters=3)
        return ok

    def full_block_cases(tables, name, per_expert_bytes, cases):
        """The full-expert-block prefill mode (full_block=True) against the exact
        plain rows, its plain version: g, u over all of m in fp32, a rounded
        once, the down product over all of m (fp32 sums in another order)."""
        ok = True
        for label, n, choices in cases:
            x = torch.randn((n, h), device=dev, generator=g).to(bf)
            idx, w = routing(n, choices)
            nbytes, ops = moe_work(idx, n, per_expert_bytes, 2)
            ok &= run_case(torch, results, name, label,
                           lambda: moe_experts_swiglu_gmm(tables, x, idx, w, E, layer_idx=0, full_block=True),  # noqa: B023
                           lambda: moe_experts_swiglu_gmm_plain(tables, x, idx, w, E, layer_idx=0),  # noqa: B023
                           nbytes, ops, "bf16", iters=5, plain_iters=2)
        return ok

    # int4 and int8 tables of the same weights
    q4 = {n: quantize_array(t, 4) for n, t in experts.items()}
    q8 = {n: quantize_array(t, 8) for n, t in experts.items()}
    del experts
    torch.cuda.empty_cache()
    per_expert = 3 * h * m // 2 + (2 * m + h) * 4
    all_ok &= decode_moe_cases(torch, results, q4, routing, g, h, m, name="moe_stream_q4s8")
    for label, n, choices in prefill:
        x = torch.randn((n, h), device=dev, generator=g).to(bf)
        idx, w = routing(n, choices)
        nbytes, ops = moe_work(idx, n, per_expert, 2)
        all_ok &= run_case(torch, results, "moe_swiglu_gmm_q4", label,
                           lambda: moe_experts_swiglu_gmm(q4, x, idx, w, E, layer_idx=0),  # noqa: B023
                           lambda: moe_experts_swiglu_gmm_plain(q4, x, idx, w, E, layer_idx=0),  # noqa: B023
                           nbytes, ops, "bf16")
    all_ok &= capacity_cases(q4, "moe_swiglu_gmm_q4", per_expert)
    all_ok &= dot_mode_cases(q4, "moe_stream_q4", "moe_swiglu_gmm_q4s8", per_expert)
    all_ok &= full_block_cases(q4, "moe_swiglu_gmm_q4_full", per_expert,
                               prefill + [(f"{n_und} tok x k=6 (the understanding prompt's length), sorted dispatch",
                                           n_und, None)])
    del q4

    # int8 tables: 3 h m bytes and 2 m + h fp32 scales per routed expert. The decode kernel in both dot modes
    # (s8 dots: int8 operations, held to the bit, with its kernel-alone time; exact dequant: products at the
    # bf16 rate), at the slice's 2 rows, the editing loop's 3 and a serving step's 16, and the exact one first
    # at the understanding round's 1 row (its main path: `understand` with moe_int_dots=False)
    per_expert = 3 * h * m + (2 * m + h) * 4
    decode8 = decode[:1] + [("N=3 k=6 (editing decode)", 3, None)] + decode[1:]
    for name, int_dots, kind, cases in (
            ("moe_stream_q8s8", True, "int8", decode8),
            ("moe_stream_q8", False, "bf16", [("N=1 k=6 (understanding text decode)", 1, None)] + decode8)):
        for label, n, choices in cases:
            x = torch.randn((n, h), device=dev, generator=g).to(bf)
            idx, w = routing(n, choices)
            nbytes, ops = moe_work(idx, n, per_expert, 2)
            kw = dict(layer_idx=0, int_dots=int_dots)
            kern = lambda: moe_experts_stream(q8, x, idx, w, **kw)  # noqa: B023, E731
            all_ok &= run_case(torch, results, name, label, kern,
                               lambda: moe_experts_stream_plain(q8, x, idx, w, **kw),  # noqa: B023
                               nbytes, ops, kind, bitwise=int_dots)
            if int_dots:  # 7a: two launches, its kernel-alone time
                all_ok &= one_launch_checks(torch, results, name, kern, kernels=2)
    for label, n, choices in prefill:
        x = torch.randn((n, h), device=dev, generator=g).to(bf)
        idx, w = routing(n, choices)
        nbytes, ops = moe_work(idx, n, per_expert, 2)
        all_ok &= run_case(torch, results, "moe_swiglu_gmm_q8", label,
                           lambda: moe_experts_swiglu_gmm(q8, x, idx, w, E, layer_idx=0),  # noqa: B023
                           lambda: moe_experts_swiglu_gmm_plain(q8, x, idx, w, E, layer_idx=0),  # noqa: B023
                           nbytes, ops, "bf16")
    all_ok &= capacity_cases(q8, "moe_swiglu_gmm_q8", per_expert)
    all_ok &= dot_mode_cases(q8, None, "moe_swiglu_gmm_q8s8", per_expert)
    all_ok &= full_block_cases(q8, "moe_swiglu_gmm_q8_full", per_expert, prefill[:1])
    del q8

    all_ok &= decode_attention_cases(torch, results, g, cfg)
    all_ok &= flash_prefill_cases(torch, results, g, cfg)
    all_ok &= flash_vit_cases(torch, results, g, cfg)

    # the RF head at full width, int4 then int8, its AdaLN weights at the slice's std 0.02. The random head is
    # chaotic at the int4 sampler's s8 boundaries and at the int8 sampler's bf16 roundings (a 1-ulp change of
    # its input moves the sample by several percent over 16 steps, see `--phases rf_sensitivity`), so each plain
    # version gives its kernel's bits (the int4 one summing in its kernel's order, the int8 one's dots exact
    # before one rounding) and each pair is held to the bit.
    rf_cfg = cfg.rf_head
    L, w, C, St = rf_cfg.depth, rf_cfg.width, rf_cfg.target_channels, rf_cfg.num_sampling_steps
    ts, dts = _time_grid(rf_cfg, None, device=dev)

    def tables_bytes(bits, Hd):
        """The blocks' tables, their scales and biases, and the LN affines."""
        return L * 3 * w * Hd * bits // 8 + L * (2 * Hd + w) * 4 * 2 + 2 * L * w * 4

    def stack_cases(rf, bits, Hd, modes):
        """One Euler step of the per-step stack (all 12 blocks, the tables read
        once) at full width, 2 and 3 rows, bf16, in each (kernel name, s8 dots)
        of `modes`: the kernel against its plain version, which sums in its
        order, to the bit."""
        ok = True
        for rows in (2, 3):
            z = torch.randn((rows, rf_cfg.z_channels), device=dev, generator=g).to(bf)
            mods = precompute_modulations(rf, rf_cfg, ts, z)[0][:, 0]  # step 0's (L, rows, 3w)
            x = torch.randn((rows, w), device=dev, generator=g).to(bf)
            nbytes = tables_bytes(bits, Hd) + mods.numel() * 2 + 2 * x.numel() * 2
            for name, s8 in modes:
                kw = dict(ln_eps=rf_cfg.ln_eps, int_dots=s8)
                ok &= run_case(torch, results, name, f"{rows} CFG rows, one Euler step, w={w} H={Hd} {L} blocks",
                               lambda: rf_mlp_stack(rf["res_blocks"], x, mods, **kw),  # noqa: B023
                               lambda: rf_mlp_stack_plain(rf["res_blocks"], x, mods, **kw),  # noqa: B023
                               nbytes, 2.0 * 3 * w * Hd * rows * L, "int8" if s8 else "bf16", plain_iters=1,
                               bitwise=True)
        return ok

    def pipelined_cases(rf, Hd):
        """The int4 sampler's pipelined schedule (w3 in 1,024-row pieces) at 2
        rows and 3 with renorm, beside the block schedule in the same call: to
        the bit against its plain version."""
        ok = True
        for rows, renorm in ((2, False), (3, True)):
            z = torch.randn((rows, rf_cfg.z_channels), device=dev, generator=g).to(bf)
            block_mods, final_mods = precompute_modulations(rf, rf_cfg, ts, z)
            noise = torch.randn((1, C), device=dev, generator=g).repeat(rows, 1)
            args = (rf, rf_cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
            kw = dict(cfg_rows=rows, renorm_channel=renorm, compute_dtype=bf)
            rest = (L * St * rows * 3 * w + St * rows * 2 * w) * 4 + 2 * C * w * 4 + 2 * rows * C * 4
            ok &= run_case(torch, results, "rf_sampler_q4s8_pipelined",
                           f"{rows} CFG rows{' + channel renorm' if renorm else ''}, w={w} H={Hd} {L} blocks {St} "
                           "steps, down_chunk 1024",
                           lambda: rf_sample_fused(*args, schedule="pipelined", **kw),  # noqa: B023
                           lambda: rf_sample_fused_plain(*args, schedule="pipelined", **kw),  # noqa: B023
                           St * tables_bytes(4, Hd) + rest, 2.0 * 3 * w * Hd * rows * L * St, "int8", iters=3,
                           plain_iters=1, others={"block_schedule": lambda: rf_sample_fused(*args, **kw)},  # noqa: B023
                           bitwise=True)
        return ok
    for bits, name, counter, kind, s8 in ((4, "rf_sampler_q4s8", rf_sample_fused, "int8", False),
                                          (8, "rf_sampler_q8", rf_sample_fused_q8, "bf16", False),
                                          (8, "rf_sampler_q8s8", rf_sample_fused_q8s8, "int8", True)):
        rf = full_width_rf(torch, rf_cfg, g, adaln_std=0.02, bits=bits)
        Hd = rf["res_blocks"]["mlp"]["w3"]["w"].q.shape[1] * (8 // bits)
        # 2 CFG rows (T2I), 3 with renorm (editing); then more rows than one launch holds, sampled in groups of
        # whole images: 2 images x 3 rows and 4 images x 2 rows
        for rows, renorm, n_img in ((2, False, 1), (3, True, 1), (3, True, 2), (2, False, 4)):
            z = torch.randn((rows * n_img, rf_cfg.z_channels), device=dev, generator=g).to(bf)
            block_mods, final_mods = precompute_modulations(rf, rf_cfg, ts, z)
            noise = torch.randn((n_img, C), device=dev, generator=g).repeat(rows, 1)
            args = (rf, rf_cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
            kw = dict(cfg_rows=rows, renorm_channel=renorm, compute_dtype=bf, s8_dots=s8)
            launches = counter.launches
            # the blocks' tables (453 MB int4, 906 MB int8), their scales and biases, and the LN affines: more
            # than L2 and every SM's shared memory hold, so each Euler step streams them again
            B = rows * n_img
            block_weights = tables_bytes(bits, Hd)
            rest = (L * St * B * 3 * w + St * B * 2 * w) * 4 + 2 * C * w * 4 + 2 * B * C * 4
            nbytes = St * block_weights + rest
            # int4: two integer dots per weight byte pair; int8: one bf16-rate product (s8 dots: one int8
            # operation) per weight; per row, block and step
            ops = 2.0 * 3 * w * Hd * B * L * St
            label = (f"{rows} CFG rows{' + channel renorm' if renorm else ''}" if n_img == 1 else
                     f"{n_img} images x {rows} CFG rows = {B} rows")
            all_ok &= run_case(torch, results, name,
                               f"{label}, w={w} H={Hd} {L} blocks {St} steps; tables read once would be "
                               f"{bound(block_weights + rest, 0, kind)[0]:.4f} ms",
                               lambda: rf_sample_fused(*args, **kw),  # noqa: B023
                               lambda: rf_sample_fused_plain(*args, **kw), nbytes, ops, kind, iters=3,  # noqa: B023
                               plain_iters=1, bitwise=True)
            if n_img > 1:  # one launch per group of whole images that fits the kernel's rows
                launched = counter.launches - launches
                calls = 1 + 3 + 3  # the comparison, warm-up and timed calls of run_case
                print(f"kernel {name} [{label}]: {launched // calls} launches per call (groups of "
                      f"{MAX_ROWS // rows} images)")
                all_ok &= launched == calls * -(-n_img // (MAX_ROWS // rows))
        if name == "rf_sampler_q4s8":
            all_ok &= pipelined_cases(rf, Hd)
            all_ok &= stack_cases(rf, bits, Hd, (("rf_mlp_q4s8", True), ("rf_mlp_q4", False)))
        elif name == "rf_sampler_q8":
            all_ok &= stack_cases(rf, bits, Hd, (("rf_mlp_q8", False), ("rf_mlp_q8s8", True)))
        del rf
    torch.cuda.empty_cache()
    all_ok &= paged_cases(torch, results, g, cfg)
    return all_ok


def decode_mask(torch, B: int, S: int, prefix: int, dev):
    """The image loop's (B, S) mask of the main path's CFG rows: each row allows
    the first `prefix` positions (prompt and image tokens so far); every odd
    (unconditional) row skips the prompt's 30 text ids after the first."""
    mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
    mask[:, :prefix] = True
    mask[1::2, 1:31] = False
    return mask


def decode_attention_cases(torch, results, g, cfg) -> bool:
    """Decode attention (one LLM step's query against the 4,096-position cache of
    one layer) at the table's case (2 rows, 1,072 allowed positions: CFG holes
    and an isolated late position) and at the image loop's ~300-position
    prefix at 2 rows (T2I), 3 (editing) and 12 (the image pool); each beside
    SDPA on the same mask and with the kernel's own device time
    (`kernel_device_ms`, `device_ms`). The bound counts K and V at the allowed
    positions, q, the output and the mask."""
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_plain

    dev = torch.device("cuda")
    Hq, Hkv, S, D = cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads, 4096, cfg.llm.head_dim
    table = torch.zeros((2, S), dtype=torch.bool, device=dev)
    table[0, :700] = True
    table[1, :321] = True
    table[1, 400:450] = True  # CFG-style hole
    table[1, 3000:3001] = True  # an isolated allowed position in a late tile
    cases = [("B=2 S=4096 CFG holes", table)] + [
        (f"B={B} S=4096 image loop, 300-position prefix", decode_mask(torch, B, S, 300, dev)) for B in (2, 3, 12)]
    ok = True
    for label, mask in cases:
        B = mask.shape[0]
        q = torch.randn((B, 1, Hq, D), device=dev, generator=g).to(torch.bfloat16)
        kc, vc = (torch.randn((B, Hkv, S, D), device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        allowed = int(mask.sum())
        nbytes = allowed * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2 + B * S  # K and V where allowed, q, out, mask
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), kc, vc, attn_mask=mask[:, None, None, :], enable_gqa=True)  # noqa: B023
        kern = lambda: decode_attention(q, kc, vc, mask)  # noqa: B023, E731
        ok &= run_case(torch, results, "decode_attention", f"{label} ({allowed} allowed)", kern,
                       lambda: decode_attention_plain(q, kc, vc, mask),  # noqa: B023
                       nbytes, 4.0 * Hq * D * allowed, "bf16", library=sdpa)
        case = results["decode_attention"]["cases"][-1]
        case["device_ms"] = kernel_device_ms(torch, kern)
        ok &= case["device_ms"] is not None
        print(f"kernel decode_attention [{label}]: wrapper_ms={case['ms']:.4f} device_ms={fmt_ms(case['device_ms'])} "
              f"library_ms={case['library_ms']:.4f}")
    return ok


# paged decode attention's kernels, as torch.profiler names them (the one-launch kernel; before it, the split and
# combine kernels)
PAGED_KERNEL = ("paged_split_kernel", "paged_attention")

# the ViT forward's kernel, as torch.profiler names it: the forward body that also runs the prefill, or an
# older tree's ViT-only kernel
VIT_FORWARD_KERNEL = ("flash_fwd_wgmma_kernel<", "flash_vit_wgmma_kernel<")


def flash_vit_cases(torch, results, g, cfg) -> bool:
    """The ViT flash forward at the pixel decoder's shape (16 heads x 1,024
    tokens x 64) at 1, 2 and 8 images, without and with residuals (the lse
    beside the output, held within 1e-4 of its plain version: the backward
    kernels read it): the wrapper's time, the kernel-alone device time
    (`kernel_device_ms`), and SDPA's forward."""
    from mingunivision_tpu_torch.ops.kernels import flash

    dev = torch.device("cuda")
    H, N, D = cfg.mingtok.pixel_decoder.num_heads, 1024, cfg.mingtok.pixel_decoder.embed_dim // 16
    scale = D**-0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ok = True
    for B in (1, 2, 8):
        q, k, v = (torch.randn((B, H, N, D), device=dev, generator=g).to(torch.bfloat16) for _ in range(3))
        for with_lse in (False, True):
            label = f"{B}x{H}x{N}x{D} head-major" + (", with residuals (out, lse)" if with_lse else "")
            if with_lse:
                kern = lambda: flash.flash_vit_attention_lse(q, k, v, scale=scale)  # noqa: B023, E731
                plain = lambda: flash.flash_vit_attention_lse_plain(q, k, v, scale=scale)  # noqa: B023, E731
            else:
                kern = lambda: flash.flash_vit_attention(q, k, v, scale=scale)  # noqa: B023, E731
                plain = lambda: flash.flash_vit_attention_plain(q, k, v, scale=scale)  # noqa: B023, E731
            ok &= run_case(torch, results, "flash_vit", label, kern, plain,
                           4 * q.numel() * 2 + (B * H * N * 4 if with_lse else 0), 4.0 * D * H * N * N * B, "bf16",
                           library=lambda: sdpa(q, k, v))  # noqa: B023
            if with_lse:  # the lse on its own tolerance
                lse_err = (kern()[1] - plain()[1]).abs().max().item()
                ok &= lse_err <= 1e-4 * plain()[1].abs().max().item() + 1e-5
            case = results["flash_vit"]["cases"][-1]
            case["device_ms"] = kernel_device_ms(torch, kern)
            ok &= case["device_ms"] is not None
            print(f"kernel flash_vit [{label}]: wrapper_ms={case['ms']:.4f} device_ms={fmt_ms(case['device_ms'])} "
                  f"library_ms={case['library_ms']:.4f}" + (f"; lse max_abs_err={lse_err:.3e}" if with_lse else ""))
        del q, k, v
    return ok


def flash_prefill_cases(torch, results, g, cfg, alone: bool = False) -> bool:
    """The flash prefill at the understanding prompt's shape (1 x 1,152 tokens x
    16 / 4 heads x 128; 92 padding rows, and none) against its plain version
    (every row finite, the valid rows within REL_TOL), beside SDPA: with
    `is_causal=True, enable_gqa=True` where there is no padding (the same
    function), with the boolean mask of the same rule in both cases (a
    boolean mask keeps SDPA off its flash backend); operations counted over
    the allowed query-key pairs. `alone`: also each one's device time per
    call with the host out of the way (`kernel_device_ms`), and the kernel's
    device events and allocations per call."""
    from mingunivision_tpu_torch.ops.kernels.flash import flash_prefill_attention, flash_prefill_attention_plain

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Hq, Hkv, D, T, n_pad = cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads, cfg.llm.head_dim, 1152, 92
    ok = True
    for label, pads in ((f"1x{T}x{Hq}/{Hkv}x{D}, {n_pad} pads", n_pad), (f"1x{T}x{Hq}/{Hkv}x{D}, no pads", 0)):
        q = torch.randn((1, T, Hq, D), device=dev, generator=g).to(torch.bfloat16)
        kk = torch.randn((1, T, Hkv, D), device=dev, generator=g).to(torch.bfloat16)
        vv = torch.randn((1, T, Hkv, D), device=dev, generator=g).to(torch.bfloat16)
        valid = (torch.arange(T, device=dev) < T - pads)[None]
        pos = torch.arange(T, device=dev)
        allowed2d = (pos[None, :] <= pos[:, None]) & (valid[0][:, None] == valid[0][None, :])
        pairs = int(allowed2d.sum())
        nbytes = (2 * q.numel() + kk.numel() + vv.numel()) * 2 + T
        qh, kh, vh = q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)
        kern = lambda: flash_prefill_attention(q, kk, vv, valid, scale=D**-0.5)  # noqa: B023, E731
        masked = lambda: sdpa(qh, kh, vh, attn_mask=allowed2d[None, None], enable_gqa=True)  # noqa: B023, E731
        causal = lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)  # noqa: B023, E731
        ok &= run_case(torch, results, "flash_prefill", label, kern,
                       lambda: flash_prefill_attention_plain(q, kk, vv, valid, scale=D**-0.5),  # noqa: B023
                       nbytes, 4.0 * D * Hq * pairs, "bf16", library=masked if pads else causal,
                       others={} if pads else {"sdpa_bool_mask": masked})
        ok &= bool(torch.isfinite(kern().float()).all())
        case = results["flash_prefill"]["cases"][-1]
        case["library"] = "SDPA, boolean mask" if pads else "SDPA, is_causal=True, enable_gqa=True"
        if alone:
            case["device_ms"] = kernel_device_ms(torch, kern)
            case["library_device_ms"] = kernel_device_ms(torch, masked if pads else causal)
            if not pads:
                case["sdpa_bool_mask_device_ms"] = kernel_device_ms(torch, masked)
            per_call, names = kernels_per_call(torch, kern)
            case.update(kernels_per_call=per_call, kernel_names=names,
                        allocations_per_call=allocations_per_call(torch, kern))
            ok &= case["device_ms"] is not None and 0 < per_call <= 1
            extra = "" if pads else f" sdpa_bool_mask_alone_ms={fmt_ms(case['sdpa_bool_mask_device_ms'])}"
            print(f"prefill_kernels flash_prefill [{label}]: wrapper_ms={case['ms']:.4f} "
                  f"alone_ms={fmt_ms(case['device_ms'])} library ({case['library']}) ms={case['library_ms']:.4f} "
                  f"alone_ms={fmt_ms(case['library_device_ms'])}{extra} bound_ms={case['bound_ms']:.4f} "
                  f"max_abs_err={case['max_abs_err']:.3e} device events per call {per_call:g} {names} "
                  f"allocations per call {case['allocations_per_call']}")
    return ok


def paged_inputs(torch, g, B: int, Hq: int, Hkv: int, D: int, page: int = 64, maxp: int = 32):
    """Paged attention inputs as the serving engine lays them out, one layer's
    pool: row lengths cycling through 0, 1, 63, 64, 65, 700 and 2047 (a row of
    length 0 is an idle slot), page ids shuffled over the pool, rows 0 and 1
    sharing their first two pages (a prefix-cache hit), and the scratch page,
    every page's tail past its row's length and every unused page filled with
    +-1e4. Returns (q, k_pages, v_pages, tables, lengths)."""
    cycle = [0, 1, 63, 64, 65, 700, 2047]
    lengths = [cycle[(b + 5) % len(cycle)] for b in range(B)]
    if B > 1:
        lengths[:2] = [700, 2047]
    need = [-(-n // page) for n in lengths]
    P = sum(need) + 4  # a few pages no row owns
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(B)).tolist()
    tables = torch.full((B, maxp), P, dtype=torch.int32)
    for b in range(B):
        shared = tables[0, :2].tolist() if b == 1 else []
        tables[b, : need[b]] = torch.tensor(shared + [perm.pop() for _ in range(need[b] - len(shared))],
                                            dtype=torch.int32)
    dev = torch.device("cuda")
    kp = torch.full((Hkv, P + 1, page, D), 1e4, device=dev, dtype=torch.bfloat16)
    vp = torch.full((Hkv, P + 1, page, D), -1e4, device=dev, dtype=torch.bfloat16)
    for b in range(B):
        for i in range(need[b]):
            n, pid = min(page, lengths[b] - i * page), int(tables[b, i])
            kp[:, pid, :n] = torch.randn((Hkv, n, D), device=dev, generator=g).to(torch.bfloat16)
            vp[:, pid, :n] = torch.randn((Hkv, n, D), device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn((B, 1, Hq, D), device=dev, generator=g).to(torch.bfloat16)
    return q, kp, vp, tables.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)


def kernels_per_call(torch, fn, calls: int = 5):
    """(device events per call of `fn`, their names) over `calls` calls under
    torch.profiler, after a warm-up call: kernels, copies and fills alike. The
    profiler drops launches now and then (once a whole window's), so a count
    below the launches made is possible, none above; a window with no event
    is taken again, three times in all."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    names = {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", name)[:60] for name in events}
    return len(events) / calls, sorted(names)


def allocations_per_call(torch, fn) -> int:
    """Device allocations one call of `fn` makes, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - before


def one_launch_checks(torch, results, name, fn, kernels: int) -> bool:
    """The last case of `name` gains its kernel-alone device time
    (`kernel_device_ms`), its device events per call (at most `kernels`, all
    kernels) and its allocations per call (the output's only)."""
    case = results[name]["cases"][-1]
    case["device_ms"] = kernel_device_ms(torch, fn)
    per_call, names = kernels_per_call(torch, fn)
    case.update(kernels_per_call=per_call, allocations_per_call=allocations_per_call(torch, fn))
    ok = case["device_ms"] is not None and 0 < per_call <= kernels and case["allocations_per_call"] == 1
    library = "none" if case["library_ms"] is None else f"{case['library_ms']:.4f}"
    print(f"kernel {name} [{case['shape']}]: wrapper_ms={case['ms']:.4f} device_ms={fmt_ms(case['device_ms'])} "
          f"library_ms={library} device events per call {per_call:g} (at most {kernels}) {names}, "
          f"allocations per call {case['allocations_per_call']} {'ok' if ok else 'FAILED'}")
    return ok


def paged_cases(torch, results, g, cfg) -> bool:
    """The paged decode-attention kernel against its plain version (gather +
    masked attention) at the serving engine's shapes: 16 / 4 heads of 128,
    page 64, 32 table entries (max_len 2048), batch 1, 8 and 16; each with its
    kernel-alone device time and one kernel per call. Library line: SDPA on
    the dense view gathered beforehand. Bound: the K/V bytes at the rows'
    valid positions, q, out, tables and lengths."""
    from mingunivision_tpu_torch.ops.kernels.paged_attention import paged_decode_attention, paged_gather_attention

    Hq, Hkv, D = cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads, cfg.llm.head_dim
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ok = True
    for B in (1, 8, 16):
        q, kp, vp, tables, lengths = paged_inputs(torch, g, B, Hq, Hkv, D)
        page, maxp = kp.shape[2], tables.shape[1]
        ids = tables.long()
        kg, vg = (t[:, ids].transpose(0, 1).reshape(B, Hkv, maxp * page, D) for t in (kp, vp))
        mask = (torch.arange(maxp * page, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
        n_pos = int(lengths.sum())
        nbytes = n_pos * Hkv * D * 2 * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + B * 4
        label = f"B={B} {Hq}/{Hkv}x{D} page {page} maxp {maxp}, lengths {lengths.tolist()}"
        kern = lambda: paged_decode_attention(q, kp, vp, tables, lengths)  # noqa: B023, E731
        ok &= run_case(torch, results, "paged_attention", label, kern,
                       lambda: paged_gather_attention(q, kp, vp, tables, lengths), nbytes,  # noqa: B023
                       4.0 * Hq * D * n_pos, "bf16",
                       library=lambda: sdpa(q.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True))  # noqa: B023
        got = kern()
        ok &= not bool(got[lengths == 0].any())  # an idle row gives zeros
        ok &= one_launch_checks(torch, results, "paged_attention", kern, kernels=1)
    return ok


# the two-launch decode MoE kernels: name -> (the tables' bytes per expert from (h, m), integer dots (the dot
# mode `moe_experts_stream` takes; their operations at the int8 rate), held to the bit)
DECODE_MOE = {"moe_stream": (lambda h, m: 3 * h * m * 2, True, False),
              "moe_stream_q4s8": (lambda h, m: 3 * h * m // 2 + (2 * m + h) * 4, True, True),
              "moe_stream_q8s8": (lambda h, m: 3 * h * m + (2 * m + h) * 4, True, True),
              "moe_stream_q4": (lambda h, m: 3 * h * m // 2 + (2 * m + h) * 4, False, False)}


def decode_moe_cases(torch, results, experts, routing, g, h: int, m: int, name: str = "moe_stream") -> bool:
    """A two-launch decode MoE kernel against its plain version on layer 0 of
    the stacked 16B-A3B tables, top-6: `name` "moe_stream" on bf16 tables
    (within REL_TOL), "moe_stream_q4s8" on linear int4 tables (s8 dots, held
    to the bit), "moe_stream_q8s8" on int8 tables (s8 dots, held to the bit),
    "moe_stream_q4" on int4 tables (exact dequant, within REL_TOL); through
    `moe_experts_stream`, as the LLM step calls it. 1 row (text decode), 2 (the
    T2I step), 3 (editing), 12 (the image pool's 4 slots x 3 rows) and 16 (the
    16-slot serving step, 64 experts routed of 96 assignments); each with its
    kernel-alone device time and at most two kernels and one allocation per
    call. Bound: every routed expert's three tables once (int4 and int8: the
    bytes and the fp32 scales), x and the output."""
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream, moe_experts_stream_plain

    per_expert, int_dots, bitwise = DECODE_MOE[name]
    per_expert = per_expert(h, m)
    ok = True
    for label, n in (("N=2 k=6 (slice decode)", 2), ("N=16 k=6 (A>E dedup, 16-slot serving step)", 16),
                     ("N=1 k=6 (text decode)", 1), ("N=3 k=6 (editing decode)", 3), ("N=12 k=6 (image pool)", 12)):
        x = torch.randn((n, h), device="cuda", generator=g).to(torch.bfloat16)
        idx, w = routing(n)
        unique = int(torch.unique(idx).numel())
        nbytes, ops = unique * per_expert + 2 * n * h * 2, 6.0 * idx.numel() * h * m
        kern = lambda: moe_experts_stream(experts, x, idx, w, layer_idx=0, int_dots=int_dots)  # noqa: B023, E731
        ok &= run_case(torch, results, name, f"{label}, {unique} experts", kern,
                       lambda: moe_experts_stream_plain(experts, x, idx, w, layer_idx=0,  # noqa: B023
                                                        int_dots=int_dots),
                       nbytes, ops, "int8" if bitwise else "bf16", bitwise=bitwise)
        ok &= one_launch_checks(torch, results, name, kern, kernels=2)
    return ok


def run_decode_kernels(torch, results: dict) -> bool:
    """The decode_kernels phase: paged decode attention and the decode MoE on
    bf16 tables, on int4 tables (s8 dots and exact dequant) and on int8
    tables (s8 dots) as the kernels phase checks them, on their own
    full-width inputs."""
    from mingunivision_tpu_torch.config import MingUniVisionConfig
    from mingunivision_tpu_torch.utils.quantize import quantize_array

    cfg = MingUniVisionConfig()
    g = torch.Generator(device="cuda").manual_seed(0)
    E, h, m, k = cfg.llm.num_experts, cfg.llm.hidden_size, cfg.llm.moe_intermediate_size, cfg.llm.num_experts_per_tok
    shapes = {"gate_proj": (1, E, h, m), "up_proj": (1, E, h, m), "down_proj": (1, E, m, h)}
    experts = {n: torch.empty(sh, device="cuda", dtype=torch.bfloat16).normal_(0, 0.02, generator=g)
               for n, sh in shapes.items()}
    routing, _, _ = moe_cases(torch, g, E, k)
    ok = decode_moe_cases(torch, results, experts, routing, g, h, m)
    q4 = {n: quantize_array(t, 4) for n, t in experts.items()}
    ok &= decode_moe_cases(torch, results, q4, routing, g, h, m, name="moe_stream_q4s8")
    ok &= decode_moe_cases(torch, results, q4, routing, g, h, m, name="moe_stream_q4")
    del q4
    q8 = {n: quantize_array(t, 8) for n, t in experts.items()}
    del experts
    ok &= decode_moe_cases(torch, results, q8, routing, g, h, m, name="moe_stream_q8s8")
    del q8
    torch.cuda.empty_cache()
    return ok & paged_cases(torch, results, g, cfg)


# the prefill MoE kernels' CUDA kernels, as torch.profiler names them: the wgmma body of rows 2, 5 and 7c
# (`swiglu_wgmma.cuh`: 7c's transposed kernel apart) and the first versions it replaced (an older tree's, when
# this script runs from its root)
PREFILL_MOE_KERNELS = ("::swiglu_wgmma_kernel<", "::swiglu_ra_kernel<", "::gmm_up_kernel(", "::gmm_down_kernel(",
                       "::gmm_q4_up_kernel(", "::gmm_q4_down_kernel(", "::gmm_q8_up_kernel(", "::gmm_q8_down_kernel(")


def prefill_moe_device_ms(torch, averages) -> tuple:
    """(device ms, calls) of the prefill MoE's kernels (rows 2, 5 and 7c) among
    a profile's `key_averages()`."""
    cuda = torch.autograd.DeviceType.CUDA
    hits = [e for e in averages if e.device_type == cuda and any(k in e.key for k in PREFILL_MOE_KERNELS)]
    return sum(e.self_device_time_total for e in hits) / 1e3, sum(e.count for e in hits)


def prefill_tile_rows(msg, kind: str) -> int:
    """The tile rows of the prefill kernel for `kind` tables ("plain", "int4"
    or "int8", exact dequant); an older tree's `tile_rows()` takes no
    arguments (one value for every kernel)."""
    try:
        return msg.tile_rows(kind)
    except TypeError:
        return msg.tile_rows()


def run_prefill_kernels(torch, results: dict) -> bool:
    """The prefill_kernels phase: row 2 (bf16 tables), row 5 (int4 tables,
    exact dequant) and row 7c (int8 tables, exact dequant) at full width (E
    64, h 2048, m 1408, top-6) on layer 0 of the kernels phase's tables: a
    128-token prompt (T2I), the same skewed to
    8 experts, 384 tokens (editing), the understanding prompt's 1,152 tokens
    (92 pads) through the sorted and the capacity dispatch, and for row 2 the
    LM train step's 2,048 tokens (12,288 rows, sorted, as training's forward
    takes them). Each case: through the wrapper (`run_case`: ms, plain ms,
    bound, max abs err against the plain version, valid rows only), and the
    kernels alone (`swiglu_gmm_rows` over the dispatch's prepared schedule:
    `kernel_device_ms`, device events and allocations per call). Row 2 also
    beside a yardstick of three PyTorch calls computing the same function on
    the sorted rows (`torch._grouped_mm` for W1 and W3, silu * mul, the down
    `_grouped_mm`; the sort not timed), which nothing on the port's path calls.
    Then the flash prefill at the understanding prompt's shape
    (`flash_prefill_cases`). Runs from an older tree's root too (its kernels,
    this script's cases)."""
    import torch.nn.functional as F

    from mingunivision_tpu_torch.config import MingUniVisionConfig
    from mingunivision_tpu_torch.ops.kernels import moe_swiglu_gmm as msg
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import (
        capacity_schedule,
        default_capacity,
        expert_rank,
        moe_experts_capacity_gmm_exact,
        moe_experts_capacity_gmm_exact_plain,
    )
    from mingunivision_tpu_torch.utils.quantize import quantize_array

    cfg = MingUniVisionConfig()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    E, h, m, k = cfg.llm.num_experts, cfg.llm.hidden_size, cfg.llm.moe_intermediate_size, cfg.llm.num_experts_per_tok
    shapes = {"gate_proj": (1, E, h, m), "up_proj": (1, E, h, m), "down_proj": (1, E, m, h)}
    experts = {n: torch.empty(sh, device=dev, dtype=bf).normal_(0, 0.02, generator=g) for n, sh in shapes.items()}
    routing, _, prefill = moe_cases(torch, g, E, k)
    n_und, n_pad = 1152, 92
    cap = default_capacity(n_und, k, E, cfg.llm.moe_prefill_capacity_factor)
    und_valid = torch.arange(n_und, device=dev) < n_und - n_pad
    ok = True

    def prepared(tables, kind, x, idx, capacity):
        """(row_token, row_expert, sched, sorted rows, group offsets) of the
        sorted dispatch, or of the capacity one (pads routed out, as
        `moe_experts_capacity_gmm_exact` does), at the kernel's tile rows."""
        tile = prefill_tile_rows(msg, kind)
        if capacity is None:
            order, row_token, sched = msg.group_schedule(idx, E, tile)
            row_expert = None
        else:
            flat = torch.where(und_valid[:, None], idx, E).reshape(-1)
            rank, sizes = expert_rank(flat, E)
            dst, row_expert, sched, _ = capacity_schedule(flat, rank, sizes, E, capacity, tile)
            row_token = torch.zeros(E * capacity + 1, dtype=torch.int32, device=dev)
            row_token[dst] = (torch.arange(flat.numel(), device=dev) // k).to(torch.int32)
            row_token = row_token[: E * capacity]
        flat = idx.reshape(-1).long()
        xs = x[flat.argsort(stable=True) // k]
        offs = torch.bincount(flat, minlength=E).cumsum(0).to(torch.int32)
        return row_token, row_expert, sched, xs, offs

    def cases_of(tables, name, kind, per_expert, extra=()):
        nonlocal ok
        for label, n, choices, capacity in ([(lbl, n, ch, None) for lbl, n, ch in prefill]
                                            + [("384 tok x k=6 (editing prompt)", 384, None, None),
                                               (f"{n_und} tok ({n_pad} pads) x k=6, sorted dispatch", n_und, None,
                                                None),
                                               (f"{n_und} tok ({n_pad} pads) x k=6, capacity dispatch C={cap}", n_und,
                                                None, cap)] + list(extra)):
            x = torch.randn((n, h), device=dev, generator=g).to(bf)
            idx, w = routing(n, choices)
            valid = und_valid if n == n_und else None
            if valid is not None:  # the prompt's padding rows: one embedding, one routing
                x[~valid], idx[~valid], w[~valid] = x[-1].clone(), idx[-1].clone(), w[-1].clone()
            nbytes, ops = (int(torch.unique(idx if valid is None else idx[valid]).numel()) * per_expert
                           + 2 * n * h * 2, 6.0 * idx.numel() * h * m)
            if capacity is None:
                kern = lambda: msg.moe_experts_swiglu_gmm(tables, x, idx, w, E, layer_idx=0)  # noqa: B023, E731
                plain = lambda: msg.moe_experts_swiglu_gmm_plain(tables, x, idx, w, E, layer_idx=0)  # noqa: B023, E731
            else:
                kw = dict(token_valid=valid, layer_idx=0)
                kern = lambda: moe_experts_capacity_gmm_exact(tables, x, idx, w, E, capacity, **kw)  # noqa: B023, E731
                plain = lambda: moe_experts_capacity_gmm_exact_plain(tables, x, idx, w, E, capacity,  # noqa: B023, E731
                                                                     **kw)
            row_token, row_expert, sched, xs, offs = prepared(tables, kind, x, idx, capacity)
            alone = lambda: msg.swiglu_gmm_rows(tables, x, row_token, row_expert, sched, E,  # noqa: B023, E731
                                                layer_idx=0)
            others = {}
            if kind == "plain":  # the yardstick: three PyTorch grouped products and silu * mul
                w1, w3, w2 = (tables[nm][0] for nm in ("gate_proj", "up_proj", "down_proj"))

                def yardstick(xs=xs, offs=offs, w1=w1, w3=w3, w2=w2):
                    a = F.silu(torch._grouped_mm(xs, w1, offs=offs)) * torch._grouped_mm(xs, w3, offs=offs)
                    return torch._grouped_mm(a, w2, offs=offs)

                others["yardstick_3_calls"] = yardstick
            big = n >= n_und
            ok &= run_case(torch, results, name, label, kern, plain, nbytes, ops, "bf16", iters=5 if big else 20,
                           rows=valid, plain_iters=2 if big else None, others=others)
            case = results[name]["cases"][-1]
            case["device_ms"] = kernel_device_ms(torch, alone)
            per_call, names = kernels_per_call(torch, alone)
            case.update(kernels_per_call=per_call, kernel_names=names,
                        allocations_per_call=allocations_per_call(torch, alone),
                        tile_rows=prefill_tile_rows(msg, kind), scheduled_tiles=int((sched[:, 2] > sched[:, 1]).sum()))
            if "yardstick_3_calls" in others:
                case["yardstick_3_calls_device_ms"] = kernel_device_ms(torch, others["yardstick_3_calls"])
            yard = "".join(f" {key}={fmt_ms(case.get(key))}" for key in ("yardstick_3_calls_ms",
                                                                           "yardstick_3_calls_device_ms")
                           if key in case)
            print(f"prefill_kernels {name} [{label}]: wrapper_ms={case['ms']:.4f} alone_ms={fmt_ms(case['device_ms'])} "
                  f"bound_ms={case['bound_ms']:.4f} max_abs_err={case['max_abs_err']:.3e} tile_rows={case['tile_rows']} "
                  f"tiles={case['scheduled_tiles']} device events per call {per_call:g} {names} allocations per call "
                  f"{case['allocations_per_call']}{yard}")
            ok &= case["device_ms"] is not None

    train = [(f"2048 tok x k=6 (LM train step, {2048 * k} rows), sorted dispatch", 2048, None, None)]
    cases_of(experts, "moe_swiglu_gmm", "plain", 3 * h * m * 2, extra=train)
    q4 = {n: quantize_array(t, 4) for n, t in experts.items()}
    q8 = {n: quantize_array(t, 8) for n, t in experts.items()}
    del experts
    torch.cuda.empty_cache()
    cases_of(q4, "moe_swiglu_gmm_q4", "int4", 3 * h * m // 2 + (2 * m + h) * 4)
    del q4
    torch.cuda.empty_cache()
    cases_of(q8, "moe_swiglu_gmm_q8", "int8", 3 * h * m + (2 * m + h) * 4)
    del q8
    torch.cuda.empty_cache()
    return ok & flash_prefill_cases(torch, results, g, cfg, alone=True)


def run_sampler_kernels(torch, results: dict) -> bool:
    """The sampler_kernels phase: the fused RF samplers at full width on the
    kernels phase's heads (AdaLN weights at std 0.02), 2 CFG rows and 3 with
    channel renorm: the int4 one in the block and the pipelined schedule
    (down_chunk 1024), then the int8 one in both dot modes (exact; s8 dots):
    each held to the bit against its plain version, with its wrapper time and
    its kernel-alone device time (`kernel_device_ms`) with the tables warm
    (calls back to back; a step's 453 MB / 906 MB of tables are past L2 either
    way) and cold (each call behind a 256 MB write that evicts L2, that
    write's own time taken off). Public entry points only: run from an older
    tree's root, it times that tree's kernels."""
    from mingunivision_tpu_torch.config import MingUniVisionConfig
    from mingunivision_tpu_torch.models.rf_head import _time_grid, precompute_modulations
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused, rf_sample_fused_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    rf_cfg = MingUniVisionConfig().rf_head
    L, w, C, St = rf_cfg.depth, rf_cfg.width, rf_cfg.target_channels, rf_cfg.num_sampling_steps
    g = torch.Generator(device=dev).manual_seed(0)
    ts, dts = _time_grid(rf_cfg, None, device=dev)
    evict = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB, five times L2
    evict_ms = kernel_device_ms(torch, evict.zero_)
    ok = evict_ms is not None
    # (bits, [(kernel name, its arguments, the kind of its operations)]): the int8 exact mode's products are of
    # bf16 activations with int8 weights, counted at the bf16 rate as the kernels phase counts them
    for bits, cases in ((4, (("rf_sampler_q4s8", dict(schedule="block"), "int8"),
                             ("rf_sampler_q4s8_pipelined", dict(schedule="pipelined"), "int8"))),
                        (8, (("rf_sampler_q8", dict(s8_dots=False), "bf16"),
                             ("rf_sampler_q8s8", dict(s8_dots=True), "int8")))):
        rf = full_width_rf(torch, rf_cfg, g, adaln_std=0.02, bits=bits)
        Hd = rf["res_blocks"]["mlp"]["w3"]["w"].q.shape[1] * (8 // bits)
        tables = L * 3 * w * Hd * bits // 8 + L * (2 * Hd + w) * 4 * 2 + 2 * L * w * 4  # as the kernels phase
        for rows, renorm in ((2, False), (3, True)):
            z = torch.randn((rows, rf_cfg.z_channels), device=dev, generator=g).to(bf)
            block_mods, final_mods = precompute_modulations(rf, rf_cfg, ts, z)
            noise = torch.randn((1, C), device=dev, generator=g).repeat(rows, 1)
            args = (rf, rf_cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
            kw = dict(cfg_rows=rows, renorm_channel=renorm, compute_dtype=bf)
            rest = (L * St * rows * 3 * w + St * rows * 2 * w) * 2 + 2 * C * w * 4 + 2 * rows * C * 4
            for name, extra, kind in cases:
                kern = lambda: rf_sample_fused(*args, **extra, **kw)  # noqa: B023, E731
                mode = ", ".join(f"{k}={v}" for k, v in extra.items())
                label = (f"{rows} CFG rows{' + channel renorm' if renorm else ''}, {mode}, w={w} H={Hd} "
                         f"{L} blocks {St} steps")
                ok &= run_case(torch, results, name, label, kern,
                               lambda: rf_sample_fused_plain(*args, **extra, **kw),  # noqa: B023
                               St * tables + rest, 2.0 * 3 * w * Hd * rows * L * St, kind, iters=5, plain_iters=1,
                               bitwise=True)
                case = results[name]["cases"][-1]
                case["device_ms"] = kernel_device_ms(torch, kern)
                cold = kernel_device_ms(torch, lambda: (evict.zero_(), kern()))  # noqa: B023
                case["device_ms_cold"] = None if cold is None or evict_ms is None else cold - evict_ms
                ok &= case["device_ms"] is not None and case["device_ms_cold"] is not None
                print(f"kernel {name} [{label}]: wrapper_ms={case['ms']:.4f} device_ms={fmt_ms(case['device_ms'])} "
                      f"device_ms_cold={fmt_ms(case['device_ms_cold'])} (the 256 MB write alone {fmt_ms(evict_ms)}) "
                      f"bound_ms={case['bound_ms']:.4f}")
        del rf
        torch.cuda.empty_cache()
    del evict
    torch.cuda.empty_cache()
    return ok


# the per-step stack's and the gathered-expert matmul's CUDA kernels, as torch.profiler names them: the stack mode
# of the fused samplers' body and an older tree's per-step stack (when this script runs from its root); row 12's
# kernel
STACK_KERNELS = ("rf_sampler_q8_kernel<", "rf_sampler_q4s8_kernel<", "rf_mlp_kernel<")
GATHER_KERNELS = ("gathered_expert_matmul_kernel(",)


def kernel_event_ms(torch, fn, keys, calls: int = 10):
    """(mean device ms of the events of `calls` calls of `fn` whose name holds
    one of `keys`, device events per call): the kernel alone, apart from any
    other device work its wrapper does, from torch.profiler's device
    timestamps (a launch the profiler drops is left out of the mean, not
    counted as zero). None where no such event was recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        mine = [e.time_range.elapsed_us() for e in events if any(k in e.name for k in keys)]
        if mine:
            return statistics.mean(mine) / 1e3, len(events) / calls
    return None, 0


def run_stack_kernels(torch, results: dict) -> bool:
    """The stack_kernels phase: row 8, the per-step RF stack, in its four
    bodies at full width (one Euler step of the 12 blocks, 2 and 3 rows, bf16,
    the kernels phase's heads), held to the bit; and row 12, the gathered-
    expert matmul, at the pool's decode shapes (the kernels phase's cases:
    12-72 assignments on the gate table, 12 on the down table, 72 on two
    experts), within REL_TOL. Each through its wrapper (CUDA events), alone
    (`kernel_device_ms`: the wrapper's device work, 10 calls queued behind a
    sleep; and the kernel's own device time from the profiler, `kernel_ms`),
    with its device events per call and its bound; row 12 beside
    `torch._grouped_mm` over the rows sorted by expert, called and alone (the
    sort not timed). Public entry points only: run from an older tree's root,
    it times that tree's kernels."""
    from mingunivision_tpu_torch.config import MingUniVisionConfig
    from mingunivision_tpu_torch.models.rf_head import _time_grid, precompute_modulations
    from mingunivision_tpu_torch.ops.kernels.expert_matmul import gathered_expert_matmul, gathered_expert_matmul_plain
    from mingunivision_tpu_torch.ops.kernels.rf_mlp import rf_mlp_stack, rf_mlp_stack_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    cfg = MingUniVisionConfig()
    rf_cfg = cfg.rf_head
    L, w = rf_cfg.depth, rf_cfg.width
    g = torch.Generator(device=dev).manual_seed(0)
    ts, _ = _time_grid(rf_cfg, None, device=dev)
    ok = True

    def alone(name, kern, keys):
        case = results[name]["cases"][-1]
        case["device_ms"] = kernel_device_ms(torch, kern)
        case["kernel_ms"], case["events_per_call"] = kernel_event_ms(torch, kern, keys)
        print(f"kernel {name} [{case['shape']}]: wrapper_ms={case['ms']:.4f} device_ms={fmt_ms(case['device_ms'])} "
              f"kernel_ms={fmt_ms(case['kernel_ms'])} device events per call {case['events_per_call']:g} "
              f"bound_ms={case['bound_ms']:.4f} max_abs_err={case['max_abs_err']:.3e}")
        return case["device_ms"] is not None and case["kernel_ms"] is not None

    for bits, bodies in ((4, (("rf_mlp_q4s8", True), ("rf_mlp_q4", False))),
                         (8, (("rf_mlp_q8", False), ("rf_mlp_q8s8", True)))):
        rf = full_width_rf(torch, rf_cfg, g, adaln_std=0.02, bits=bits)
        Hd = rf["res_blocks"]["mlp"]["w3"]["w"].q.shape[1] * (8 // bits)
        tables = L * 3 * w * Hd * bits // 8 + L * (2 * Hd + w) * 4 * 2 + 2 * L * w * 4  # as the kernels phase
        for rows in (2, 3):
            z = torch.randn((rows, rf_cfg.z_channels), device=dev, generator=g).to(bf)
            mods = precompute_modulations(rf, rf_cfg, ts, z)[0][:, 0]  # step 0's (L, rows, 3w)
            x = torch.randn((rows, w), device=dev, generator=g).to(bf)
            nbytes = tables + mods.numel() * 2 + 2 * x.numel() * 2
            for name, s8 in bodies:
                kw = dict(ln_eps=rf_cfg.ln_eps, int_dots=s8)
                kern = lambda: rf_mlp_stack(rf["res_blocks"], x, mods, **kw)  # noqa: B023, E731
                ok &= run_case(torch, results, name, f"{rows} CFG rows, one Euler step, w={w} H={Hd} {L} blocks",
                               kern, lambda: rf_mlp_stack_plain(rf["res_blocks"], x, mods, **kw),  # noqa: B023
                               nbytes, 2.0 * 3 * w * Hd * rows * L, "int8" if s8 else "bf16", plain_iters=1,
                               bitwise=True)
                ok &= alone(name, kern, STACK_KERNELS)
        del rf
        torch.cuda.empty_cache()

    E, h, m, k = cfg.llm.num_experts, cfg.llm.hidden_size, cfg.llm.moe_intermediate_size, cfg.llm.num_experts_per_tok
    w1 = torch.empty((E, h, m), device=dev, dtype=bf).normal_(0, 0.02, generator=g)
    w2 = torch.empty((E, m, h), device=dev, dtype=bf).normal_(0, 0.02, generator=g)
    routing, _, _ = moe_cases(torch, g, E, k)
    name = "gathered_expert_matmul"
    cases = [(f"A={rows * k} ({rows} rows x top-{k}), gate table", rows, w1, None) for rows in (2, 3, 6, 12)]
    cases += [(f"A={2 * k} (2 rows x top-{k}), down table", 2, w2, None),
              (f"A={12 * k} skewed: every assignment on experts 3 and 40, gate table", 12, w1, [3, 40])]
    for label, rows, wt, skew in cases:
        if skew is None:
            ids = routing(rows)[0].reshape(-1).to(torch.int32)
        else:
            ids = torch.tensor(skew, device=dev, dtype=torch.int32).repeat(rows * k // len(skew))
        A, (_, K, N) = ids.numel(), wt.shape
        x = torch.randn((A, K), device=dev, generator=g).to(bf)
        distinct = int(torch.unique(ids).numel())
        nbytes = distinct * K * N * 2 + A * K * 2 + A * N * 2
        order = torch.argsort(ids)
        xs, offs = x[order], torch.bincount(ids, minlength=E).cumsum(0).to(torch.int32)
        library = lambda: torch._grouped_mm(xs, wt, offs=offs)  # noqa: B023, E731
        kern = lambda: gathered_expert_matmul(x, wt, ids)  # noqa: B023, E731
        ok &= run_case(torch, results, name, f"{label}; {distinct} distinct experts", kern,
                       lambda: gathered_expert_matmul_plain(x, wt, ids), nbytes, 2.0 * A * K * N, "bf16",  # noqa: B023
                       library=library)
        ok &= alone(name, kern, GATHER_KERNELS)
        case = results[name]["cases"][-1]
        case["library_device_ms"] = kernel_device_ms(torch, library)
        print(f"kernel {name} [{case['shape']}]: torch._grouped_mm called {case['library_ms']:.4f} ms, alone "
              f"{fmt_ms(case['library_device_ms'])} ms; the kernel alone at "
              f"{case['kernel_ms'] / case['bound_ms']:.2f}x its bound" if case["kernel_ms"] else "")
        ok &= case["library_device_ms"] is not None
    del w1, w2
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phases 4-5: a small model against the fp32 reference, then the slice, both
# through the port's session
# ---------------------------------------------------------------------------


def t2i_prompt(vocab: int, image_start: int, n_text: int = 31, seed: int = 7):
    """A text-to-image prompt of `n_text` random text ids (37 ids in all by
    default) with the chat role-prefix runs, and its CFG masks from the
    processor's rule (no tokenizer on the card)."""
    import numpy as np

    from mingunivision_tpu_torch.processing.processor import build_cfg_masks

    rng = np.random.default_rng(seed)
    user_prefix = [1001, 1002, 1003]  # stands for "<role>HUMAN</role>"
    asst_prefix = [1001, 1004, 1003]  # stands for "<role>ASSISTANT</role>"
    text = rng.integers(2000, vocab - 1000, n_text).tolist()
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
    table: nibbles +-7 at scale 10/7; in an int8 one +-127 at scale 10/127): a
    probe prefill of the prompt (with the
    image `pixels` encoded and scattered over it, when given) picks the sign
    that makes its logit large and positive."""
    from mingunivision_tpu_torch.engine.generate import linear_proj_apply, prefill, scatter_image_embeds
    from mingunivision_tpu_torch.models.bailing_moe import LLMCache, embed_tokens
    from mingunivision_tpu_torch.models.mingtok import mingtok_encode
    from mingunivision_tpu_torch.utils.quantize import QuantizedArray

    img = cfg.llm.image_start_token
    w = params["llm"]["lm_head"]["w"]

    def set_column(sign):
        if isinstance(w, QuantizedArray) and w.bits == 8:
            w.q[:, img] = 127 * sign
            w.s[..., img] = 10.0 / 127.0
        elif isinstance(w, QuantizedArray):
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
ENTRIES = ("moe_stream", "moe_swiglu_gmm", "decode_attention", "rf_sampler", "rf_mlp", "flash_prefill", "moe_capacity",
           "flash_vit", "paged_attention")


@contextlib.contextmanager
def plain_versions(names=ENTRIES):
    """Route the main path's calls of the named entry points to their plain
    versions for the block (the names the model modules call them by are patched)."""
    from mingunivision_tpu_torch.engine import batch_engine, paged
    from mingunivision_tpu_torch.models import bailing_moe as bm
    from mingunivision_tpu_torch.models import rf_head, vit
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.paged_attention import paged_gather_attention
    from mingunivision_tpu_torch.ops.kernels.flash import flash_prefill_attention_plain, flash_vit_attention_plain
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import moe_experts_capacity_gmm_exact_plain
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_plain
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_plain
    from mingunivision_tpu_torch.ops.kernels.rf_mlp import rf_mlp_stack_plain
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused_plain
    from mingunivision_tpu_torch.ops.kernels import flash, moe_gmm
    from mingunivision_tpu_torch.ops.kernels import moe_swiglu_gmm as msg

    swaps = {"moe_stream": [(bm, "moe_experts_stream", moe_experts_stream_plain)],
             "moe_swiglu_gmm": [(bm, "moe_experts_swiglu_gmm", moe_experts_swiglu_gmm_plain)],
             "decode_attention": [(bm, "decode_attention", decode_attention_plain),
                                  (batch_engine, "decode_attention", decode_attention_plain)],
             "rf_sampler": [(rf_head, "rf_sample_fused", rf_sample_fused_plain)],
             "rf_mlp": [(rf_head, "rf_mlp_stack", rf_mlp_stack_plain)],
             "flash_prefill": [(bm, "flash_prefill_attention", flash_prefill_attention_plain)],
             "moe_capacity": [(bm, "moe_experts_capacity_gmm_exact", moe_experts_capacity_gmm_exact_plain)],
             "flash_vit": [(vit, "flash_vit_attention", flash_vit_attention_plain)],
             "paged_attention": [(paged, "paged_decode_attention", paged_gather_attention)],
             # training's differentiable prefill MoE: its forward and its backward's grouped matmuls
             "train_moe": [(msg, "swiglu_gmm_ad_forward", msg.moe_experts_swiglu_gmm_plain),
                           (moe_gmm, "gmm", moe_gmm.gmm_plain), (moe_gmm, "tgmm", moe_gmm.tgmm_plain)],
             # MingTok training's ViT flash attention: the forward with residuals and the two backward kernels
             "flash_vit_train": [(flash, "flash_vit_attention_lse", flash.flash_vit_attention_lse_plain),
                                 (flash, "flash_vit_bwd_dkv", flash.flash_vit_bwd_dkv_plain),
                                 (flash, "flash_vit_bwd_dq", flash.flash_vit_bwd_dq_plain)]}
    saved = [(mod, attr, getattr(mod, attr)) for entries in swaps.values() for mod, attr, _ in entries]
    for name in names:
        for swap in swaps[name]:
            setattr(*swap)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def small_model(torch, device, tier="bfloat16", per_step=False):
    """A 2-layer model with the full model's structure, bf16 on the card (the
    LLM and RF head then quantized when `tier` is "int4", "int8" or "nf4"; the
    RF head is wide enough, 192 x 512, for every table to pass the quantizer's
    size floor; with `per_step`, 256 x 512, the narrowest head the per-step
    stack takes), RF noise off (temperature 0), 16 image tokens; returns (cfg,
    params, prompt)."""
    import dataclasses

    from mingunivision_tpu_torch.config import ImageGenConfig, MingUniVisionConfig
    from mingunivision_tpu_torch.utils.convert import init_mm_params, quantize_mm_params_inplace

    base = MingUniVisionConfig()
    llm = dataclasses.replace(base.llm, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=64, moe_intermediate_size=128, num_experts=8,
                              num_experts_per_tok=2)
    rf = dataclasses.replace(base.rf_head, target_channels=8, z_channels=64, width=64 if tier == "bfloat16" else 192,
                             depth=2)
    if per_step:  # 128-aligned int4 halves: width 256, SwiGLU hidden 512
        rf = dataclasses.replace(rf, width=256, mlp_mult=3)
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
        quantize_mm_params_inplace(params, **TIERS[tier])
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
    arrays, stacked over the steps, and "first_sample" the (args, kwargs) of
    its first RF sample call."""
    import numpy as np

    from mingunivision_tpu_torch.engine import generate as gen_mod
    from mingunivision_tpu_torch.engine import session as session_mod

    seen = {}
    loop, vis_head, sample = session_mod.generate_image_tokens, gen_mod.vis_head_apply, gen_mod.rf_sample

    def capture_loop(*args, **kwargs):
        seen.update(hidden=[], latent=[], first_sample=None)
        res = loop(*args, **kwargs)
        seen.update(hidden=np.stack(seen["hidden"]), latent=np.stack(seen["latent"]),
                    sem=res.sem_tokens[0].float().cpu().numpy())
        return res

    def capture_hidden(p, x):
        seen["hidden"].append(x.float().cpu().numpy())
        return vis_head(p, x)

    def capture_latent(*args, **kwargs):
        if seen["first_sample"] is None:
            seen["first_sample"] = (args, kwargs)
        latent = sample(*args, **kwargs)
        seen["latent"].append(latent.float().cpu().numpy())
        return latent

    session_mod.generate_image_tokens, gen_mod.vis_head_apply, gen_mod.rf_sample = \
        capture_loop, capture_hidden, capture_latent
    try:
        yield seen
    finally:
        session_mod.generate_image_tokens, gen_mod.vis_head_apply, gen_mod.rf_sample = loop, vis_head, sample


def llm_entries(torch):
    """The LLM kernel entries, as `held_against_plain` takes them: the decode
    MoE, the prefill MoE through the expert-sorted and the capacity dispatch,
    decode attention, each with its plain version and every row selected."""
    from mingunivision_tpu_torch.models import bailing_moe as bm
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import moe_experts_capacity_gmm_exact_plain
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_plain
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_plain

    def every_row(i):
        return lambda args: torch.ones(args[i].shape[0], dtype=torch.bool, device=args[i].device)

    return {"decode_moe": (bm, "moe_experts_stream", moe_experts_stream_plain, every_row(1)),
            "prefill_moe": (bm, "moe_experts_swiglu_gmm", moe_experts_swiglu_gmm_plain, every_row(1)),
            "prefill_moe_capacity": (bm, "moe_experts_capacity_gmm_exact", moe_experts_capacity_gmm_exact_plain,
                                     every_row(1)),
            "decode_attention": (bm, "decode_attention", decode_attention_plain, every_row(0))}


def held_checks(errs) -> list:
    """Each LLM kernel entry within REL_TOL of its plain version at every call
    (`held_against_plain`'s record); the decode MoE, decode attention and one
    of the prefill MoE dispatches must have been called."""
    checks = [(f"{name} in context within {max(v):.3e} <= {REL_TOL} of its plain version at all {len(v)} calls",
               max(v) <= REL_TOL) for name, v in errs.items() if v]
    called = errs["decode_moe"] and errs["decode_attention"] and (errs["prefill_moe"] or errs["prefill_moe_capacity"])
    return checks + [("every LLM kernel entry called", bool(called))]


def tier_label(tier, runtime_kw) -> str:
    return tier + "".join(f" {k}={v}" for k, v in runtime_kw.items())


def run_reference(torch, device, tier="bfloat16", results=None, **runtime_kw) -> bool:
    """The small model through the kernels (bf16) and through their plain
    versions in fp32, the reference, on the same weights (`tier`: bf16, or the
    int4 or int8 tree). The kernel path must give the reference's tokens, and
    where the kernels first act, before the 16-token loop grows any bf16 ulp
    into an image difference, it may differ from the reference by at most twice
    the plain bf16 path's own error, plus 1e-2 of the reference's maximum: the
    hidden state that enters the image head at loop step 0 (prefill and one
    decode step: every LLM kernel) and, at bf16 and int4, the first RF latent
    (sampled from that hidden state: the int4 sampler, or with
    rf_fused_sampler=False the per-step stack, whose launches are counted on
    the card: one per Euler step). Every call of
    an LLM kernel entry on the kernel path is also held against its plain
    version on the same inputs (`llm_entries`, within REL_TOL). `runtime_kw`:
    RuntimeConfig fields of every run (the dot modes). The first latent is
    also held, at every tier, against the plain sampler run on the kernel
    path's own step-0 inputs (within REL_TOL: the quantized samplers agree with
    their plain versions to the bit). At int8 and NF4 the first latent against
    fp32 is printed, not held: the small model's int8 and NF4 RF heads turn a
    one-bf16-ulp change of the hidden state into a latent change of several
    1e-2 (`--phases divergence --tier int8` / `--tier nf4`), past twice the
    plain path's error. The image
    is held to shape, finite and in range; its errors are printed. With
    `results`, the per-step stack's launches are kept there: the launches of
    its main path where no full-width round runs its body."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.models import rf_head

    per_step = runtime_kw.get("rf_fused_sampler") is False
    cfg, params, prompt = small_model(torch, device, tier, per_step=per_step)
    bf16 = RuntimeConfig(max_seq_len=512, **runtime_kw)
    stack = tier_kernels(tier, bf16)[2] if per_step else None
    counter = launch_counters().get(stack)
    launches = counter.launches if counter is not None else 0
    with loop_capture() as seen:
        with held_against_plain(torch, llm_entries(torch)) as errs:
            out_k, sess_k, _ = _generate(torch, params, cfg, bf16, device, prompt, cfg.image_gen)
        stack_launches = counter.launches - launches if counter is not None else 0
        kern = (seen["hidden"][0], seen["latent"][0])
        args, kwargs = seen["first_sample"]
        with plain_versions(("rf_sampler", "rf_mlp")):
            same_inputs = rf_head.rf_sample(*args, **kwargs).float().cpu().numpy()
        with plain_versions():
            out_r = _generate(torch, as_f32(params), cfg,
                              RuntimeConfig(max_seq_len=512, compute_dtype="float32", **runtime_kw), device, prompt,
                              cfg.image_gen)[0]
            ref = (seen["hidden"][0], seen["latent"][0])
            out_p = _generate(torch, params, cfg, bf16, device, prompt, cfg.image_gen)[0]
            plain = (seen["hidden"][0], seen["latent"][0])
    checks = image_checks(out_k, sess_k, cfg, prompt[0].shape[1], cfg.mingtok.encoder.img_size)
    checks.append(("tokens == fp32 reference", out_k.token_ids == out_r.token_ids))
    checks += held_checks(errs)
    if per_step and device.type == "cuda":  # the per-step route went through its stack kernel, every Euler step
        n = cfg.image_gen.num_image_tokens * cfg.rf_head.num_sampling_steps
        checks.append((f"{stack} launches {stack_launches} == {n}", stack_launches == n))
        if results is not None:
            entry = results.setdefault(stack, {})
            entry.setdefault("launches_by_path", {})[f"reference {tier_label(tier, runtime_kw)}"] = stack_launches
            entry["launches"] = stack_launches
    printed = []
    for i, what in enumerate(("step-0 hidden", "first latent")):
        scale = float(np.abs(ref[i]).max())
        err_k, err_p = (float(np.abs(run[i] - ref[i]).max()) for run in (kern, plain))
        tol = 2 * err_p + 1e-2 * scale
        label = f"{what} err vs fp32 {err_k:.3e} <= {tol:.3e} (plain bf16 err {err_p:.3e}, max |ref| {scale:.3e})"
        if what == "first latent" and tier in ("int8", "nf4"):
            printed.append(f"{label} (not held)")
        else:
            checks.append((label, bool(np.isfinite(kern[i]).all()) and err_k <= tol))
    err_s, scale_s = float(np.abs(kern[1] - same_inputs).max()), float(np.abs(same_inputs).max())
    checks.append((f"first latent err vs the plain sampler on its own inputs {err_s:.3e} <= "
                   f"{REL_TOL * scale_s:.3e}", bool(np.isfinite(kern[1]).all()) and err_s <= REL_TOL * scale_s))
    img_err = [float(np.abs(o.images[0] - out_r.images[0]).max()) if len(o.images) == 1 else float("inf")
               for o in (out_k, out_p)]
    print(f"reference ({tier_label(tier, runtime_kw)} small model on the card: kernels bf16 vs plain fp32): "
          + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks) + "".join(f"; {t}" for t in printed)
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


def run_reference_image(torch, device, tier="bfloat16", **runtime_kw) -> bool:
    """The small model on an image prompt that pads to 512 tokens: a 128-px image
    (64 patch tokens, the encoder's positional embedding interpolated) and 380
    text ids, then 4 greedy text tokens. The kernel path (bf16: the encoder,
    flash prefill, the capacity MoE dispatch, then the decode kernels) against
    the plain versions in fp32 on the same weights: the same tokens, every LLM
    kernel entry's call within REL_TOL of its plain version on the same inputs,
    and the prefill's last-position hidden state within twice the plain bf16
    path's own error plus 1e-2 of the reference's maximum. `runtime_kw`:
    RuntimeConfig fields of every run (the dot modes)."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig

    cfg, params, _ = small_model(torch, device, tier)
    steer_text_head(params, cfg)
    prompt, pixels = image_prompt(cfg, 64, 380, seed=11), pixel_values(128, seed=12)
    bf16 = RuntimeConfig(max_seq_len=1024, **runtime_kw)
    kw = dict(pixels=pixels, max_new_tokens=4)
    with prefill_capture() as seen:
        with held_against_plain(torch, llm_entries(torch)) as errs:
            out_k, sess_k, _ = _generate(torch, params, cfg, bf16, device, prompt, **kw)
        kern = seen["hidden"]
        with plain_versions():
            out_r = _generate(torch, as_f32(params), cfg,
                              RuntimeConfig(max_seq_len=1024, compute_dtype="float32", **runtime_kw), device, prompt,
                              **kw)[0]
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
    checks += held_checks(errs)
    print(f"reference ({tier_label(tier, runtime_kw)} small model on the card, image prompt: kernels bf16 vs plain "
          "fp32): "
          + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks)
          + f"; tokens {out_k.token_ids}, plain bf16 {out_p.token_ids}")
    return all(p for _, p in checks)


@contextlib.contextmanager
def step_logits_capture():
    """For the block, record the logits (B, V) of every serving-engine decode
    step (the admission prefills' logits are not recorded); yields the list."""
    from mingunivision_tpu_torch.engine import batch_engine

    seen = []
    logits_fn = batch_engine.compute_logits

    def capture(params, cfg, hidden):
        out = logits_fn(params, cfg, hidden)
        seen.append(out[:, -1].float().cpu().numpy())
        return out

    batch_engine.compute_logits = capture
    try:
        yield seen
    finally:
        batch_engine.compute_logits = logits_fn


def run_reference_serve(torch, device) -> bool:
    """The small model's paged serving engine (4 slots, page 64) with mid-flight
    admission: request 0, two steps, request 1 (its prompt crosses a page
    boundary), two steps, requests 2 and 3, then to completion, 8 greedy
    tokens each (the LM head steered as in `understand`). The kernel path
    (bf16: paged attention, decode MoE, prefill MoE) against the plain
    versions in fp32 on the same weights: the same tokens, and each request's
    first decode-step logits within twice the plain bf16 path's own error plus
    1e-2 of the reference's maximum."""
    import numpy as np

    from mingunivision_tpu_torch.engine.paged import PagedBatchingEngine

    cfg, params, _ = small_model(torch, device)
    steer_text_head(params, cfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2000, cfg.llm.vocab_size - 1000, n) for n in (40, 70, 130, 20)]
    first_step = [(0, 0), (2, 1), (4, 2), (4, 3)]  # request -> (engine step, slot) of its first decode step

    def serve(params, dtype):
        eng = PagedBatchingEngine(params["llm"], cfg.llm, slots=4, max_len=512, page_size=64, dtype=dtype)
        with step_logits_capture() as seen:
            reqs = [eng.add_request(prompts[0], 8)]
            for ids in (prompts[1], None):
                eng.step()
                eng.step()
                reqs += [eng.add_request(ids, 8)] if ids is not None else [eng.add_request(p, 8) for p in prompts[2:]]
            eng.run_to_completion()
        return [r.tokens for r in reqs], np.stack([seen[step][slot] for step, slot in first_step])

    tok_k, kern = serve(params, torch.bfloat16)
    with plain_versions():
        tok_r, ref = serve(as_f32(params), torch.float32)
        tok_p, plain = serve(params, torch.bfloat16)
    scale = float(np.abs(ref).max())
    err_k, err_p = float(np.abs(kern - ref).max()), float(np.abs(plain - ref).max())
    tol = 2 * err_p + 1e-2 * scale
    checks = [("8 tokens per request", all(len(t) == 8 for t in tok_k)), ("tokens == fp32 reference", tok_k == tok_r),
              (f"first-step logits err vs fp32 {err_k:.3e} <= {tol:.3e} (plain bf16 err {err_p:.3e}, "
               f"max |ref| {scale:.3e})", bool(np.isfinite(kern).all()) and err_k <= tol)]
    print("reference (bf16 small model on the card, paged serving engine, 4 slots, mid-flight admission: kernels "
          "bf16 vs plain fp32): " + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks)
          + f"; plain bf16 tokens == fp32 {tok_p == tok_r}")
    return all(p for _, p in checks)


def run_divergence(torch, device, tier="bfloat16") -> bool:
    """Where the small model's paths part (at `tier`): the plain bf16 path,
    each kernel alone swapped into it, all kernels, the plain bf16 path with
    the hidden state that enters the image head moved by one bf16 ulp (each
    element times 1 +- 2**-8), and the plain fp32 reference. Against the plain
    bf16 path and against fp32, the max abs error of: the LLM's hidden state
    that enters the image head at loop step 0 (prefill and one decode step:
    where the LLM kernels act) and at any of the 16 steps; the first RF latent
    (sampled from the step-0 hidden state: where the sampler acts on a
    quantized tier); the semantic token the loop emits, at step 0 and at any
    step; the image. A kernel fault shows as an error well above what bf16, or
    a 1-ulp change, costs the plain path."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.engine import generate as gen_mod

    cfg, params, prompt = small_model(torch, device, tier)
    # the small model's entry points, named as their kernels
    kernels = BF16_KERNELS + (() if tier in ("bfloat16", "nf4") else ("rf_sampler",))

    def run(params, plain, compute_dtype="bfloat16"):
        with plain_versions(plain):
            out, _, _ = _generate(torch, params, cfg, RuntimeConfig(max_seq_len=512, compute_dtype=compute_dtype),
                                  device, prompt, cfg.image_gen)
        return seen["hidden"], seen["latent"][0], seen["sem"], out.images[0]

    def ulp_hidden():
        """The plain bf16 path with the image head's input moved by one bf16 ulp."""
        head = gen_mod.vis_head_apply
        g = torch.Generator(device=device).manual_seed(1)

        def moved(p, x):
            sign = torch.randint(0, 2, x.shape, device=x.device, generator=g) * 2 - 1
            return head(p, (x.float() * (1 + sign * 2.0**-8)).to(x.dtype))

        gen_mod.vis_head_apply = moved
        try:
            return run(params, kernels)
        finally:
            gen_mod.vis_head_apply = head

    with loop_capture() as seen:
        ref = run(as_f32(params), kernels, "float32")
        base = run(params, kernels)
        variants = {"plain bf16": base, "all kernels": run(params, ())}
        for name in kernels:
            variants[f"only {name}"] = run(params, tuple(n for n in kernels if n != name))
        variants["plain bf16, 1-ulp hidden"] = ulp_hidden()
    print(f"divergence ({tier}): small model, {cfg.image_gen.num_image_tokens} image tokens; fp32 max |hidden| "
          f"{np.abs(ref[0]).max():.3e}, max |latent| {np.abs(ref[1]).max():.3e}, max |sem| {np.abs(ref[2]).max():.3e}")
    ok = True
    for label, (hid, lat, sem, img) in variants.items():
        errs = []
        for o_hid, o_lat, o_sem, o_img in (base, ref):
            e_hid = np.abs(hid - o_hid).reshape(len(hid), -1).max(axis=-1)
            e_sem = np.abs(sem - o_sem).max(axis=-1)
            errs.append(f"hidden step0 {e_hid[0]:.3e} any {e_hid.max():.3e}, latent step0 "
                        f"{np.abs(lat - o_lat).max():.3e}, sem step0 {e_sem[0]:.3e} any {e_sem.max():.3e}, "
                        f"image {np.abs(img - o_img).max():.3e}")
        ok &= bool(np.isfinite(hid).all() and np.isfinite(sem).all() and np.isfinite(img).all())
        print(f"divergence [{tier}, {label}]: vs plain bf16: {errs[0]} | vs fp32: {errs[1]}")
    return ok


def full_model(torch, cfg, device, tier="bfloat16", keep_rf_bf16=False):
    """Random bf16 weights of `cfg` on the device from seed 0; for `tier` "int4",
    "int8" or "nf4" the LLM and RF head are then quantized in place on the device,
    leaf by leaf. With `keep_rf_bf16`, a bf16 copy of the RF head is kept
    under params["rf_head_bf16"] (for the mixed tier). Returns params."""
    from mingunivision_tpu_torch.utils.convert import init_mm_params, quantize_mm_params_inplace
    from mingunivision_tpu_torch.utils.pytree import leaves, tree_map

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_mm_params(cfg, device=device, dtype=torch.bfloat16, generator=gen)
    randomize_adaln(params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"init: {n_params / 1e9:.3f} B params bf16 on device in {time.perf_counter() - t0:.1f} s "
          f"(allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    if keep_rf_bf16:
        params["rf_head_bf16"] = tree_map(lambda t: t.clone(), params["rf_head"])
    if tier != "bfloat16":
        t0 = time.perf_counter()
        quantize_mm_params_inplace(params, **TIERS[tier])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"quantize: LLM and RF head to {tier} on device in {time.perf_counter() - t0:.1f} s "
              f"(peak so far {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; resident "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB)")
    return params


def run_slice_mixed(torch, cfg, params, device, results: dict) -> bool:
    """The T2I round on the mixed tier, RuntimeConfig(param_dtype="int4",
    rf_param_dtype="int8"): the int4 tier's model with its RF head replaced by
    an int8 one, quantized on the card from the bf16 copy `full_model` kept
    aside (params["rf_head_bf16"], which this consumes); the int4 RF head is
    put back afterwards."""
    from mingunivision_tpu_torch.utils.quantize import quantize_tree_inplace

    rf_int4 = params["rf_head"]
    params["rf_head"] = quantize_tree_inplace(params.pop("rf_head_bf16"), bits=TIERS["int4_rf8"]["rf_bits"])
    try:
        return run_slice(torch, cfg, params, device, results, "int4_rf8")
    finally:
        params["rf_head"] = rf_int4
        torch.cuda.empty_cache()


def launch_counters():
    """kernel name -> the wrapper that counts its launches ("moe_capacity": the
    launches of the prefill MoE kernels that went through the capacity dispatch;
    "gmm_wgmma" / "gmm_trhs_wgmma" / "tgmm_wgmma": those of gmm / gmm_trhs /
    tgmm on the wgmma body)."""
    from mingunivision_tpu_torch.ops.kernels import expert_matmul, moe_gmm
    from mingunivision_tpu_torch.ops.kernels import moe_stream as ms
    from mingunivision_tpu_torch.ops.kernels import moe_swiglu_gmm as gmm
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention
    from mingunivision_tpu_torch.ops.kernels.flash import (
        flash_prefill_attention,
        flash_vit_attention,
        flash_vit_bwd_dkv,
        flash_vit_bwd_dq,
    )
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import moe_experts_capacity_gmm
    from mingunivision_tpu_torch.ops.kernels import rf_mlp
    from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs
    from mingunivision_tpu_torch.ops.kernels.paged_attention import paged_decode_attention

    return {"moe_stream": ms.moe_experts_stream, "moe_swiglu_gmm": gmm.moe_experts_swiglu_gmm,
            "decode_attention": decode_attention, "moe_stream_q4s8": ms.moe_experts_stream_q4s8,
            "moe_swiglu_gmm_q4": gmm.moe_experts_swiglu_gmm_q4, "rf_sampler_q4s8": rs.rf_sample_fused,
            "flash_prefill": flash_prefill_attention, "flash_vit": flash_vit_attention,
            "moe_capacity": moe_experts_capacity_gmm, "paged_attention": paged_decode_attention,
            "moe_stream_q8s8": ms.moe_experts_stream_q8s8, "moe_stream_q8": ms.moe_experts_stream_q8,
            "moe_swiglu_gmm_q8": gmm.moe_experts_swiglu_gmm_q8, "rf_sampler_q8": rs.rf_sample_fused_q8,
            "moe_stream_q4": ms.moe_experts_stream_q4, "moe_swiglu_gmm_q8s8": gmm.moe_experts_swiglu_gmm_q8s8,
            "moe_swiglu_gmm_q4s8": gmm.moe_experts_swiglu_gmm_q4s8, "rf_sampler_q8s8": rs.rf_sample_fused_q8s8,
            "rf_mlp_q4s8": rf_mlp.rf_mlp_stack_q4s8, "rf_mlp_q4": rf_mlp.rf_mlp_stack_q4,
            "rf_mlp_q8": rf_mlp.rf_mlp_stack_q8, "rf_mlp_q8s8": rf_mlp.rf_mlp_stack_q8s8,
            "rf_sampler_q4s8_pipelined": rs.rf_sample_fused_q4_pipelined,
            "moe_swiglu_gmm_q4_full": gmm.moe_experts_swiglu_gmm_q4_full,
            "moe_swiglu_gmm_q8_full": gmm.moe_experts_swiglu_gmm_q8_full,
            "gmm": moe_gmm.gmm, "gmm_trhs": moe_gmm.gmm_trhs, "tgmm": moe_gmm.tgmm,
            "gmm_wgmma": moe_gmm.route_counts["gmm"]["wgmma"],
            "gmm_trhs_wgmma": moe_gmm.route_counts["gmm_trhs"]["wgmma"],
            "tgmm_wgmma": moe_gmm.route_counts["tgmm"]["wgmma"],
            "flash_vit_bwd_dkv": flash_vit_bwd_dkv, "flash_vit_bwd_dq": flash_vit_bwd_dq,
            "gathered_expert_matmul": expert_matmul.gathered_expert_matmul}


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


# the weight tiers the phases run: quantize_mm_params_inplace's arguments (the int4 tier, the int8
# quality tier, the int4 LLM with an int8 RF head: RuntimeConfig(param_dtype="int4", rf_param_dtype="int8"),
# and the NF4 tier: RuntimeConfig(param_dtype="int4-nf4"))
TIERS = {"int4": dict(bits=4), "int8": dict(bits=8), "int4_rf8": dict(bits=4, rf_bits=8),
         "nf4": dict(bits=4, scheme="nf4")}
# the reference phase's small models: (tier, RuntimeConfig fields), every dot mode of every quantized tier
REFERENCE_TIERS = (("bfloat16", {}), ("int4", {}), ("int4", dict(moe_int_dots=False)), ("int8", {}),
                   ("int8", dict(moe_prefill_int_dots=True, rf_int_dots=True)), ("nf4", {}))
# and, on the card only, the per-step RF route in the four bodies of its stack kernel
PER_STEP_REFERENCE_TIERS = (("int4", dict(rf_fused_sampler=False)),
                            ("int4", dict(rf_fused_sampler=False, rf_int4_int_dots=False)),
                            ("int8", dict(rf_fused_sampler=False)),
                            ("int8", dict(rf_fused_sampler=False, rf_int_dots=True)))


def tier_kernels(tier, runtime=None):
    """(decode MoE, prefill MoE, RF head) kernel names of a tier in the dot
    modes of `runtime` (a RuntimeConfig; None: the defaults); None where the
    tier runs no kernel there (NF4: plain dequant; bf16: the RF head's loop).
    The RF head's kernel is the fused sampler, or with rf_fused_sampler=False
    the per-step stack."""
    int_dots = runtime is None or runtime.moe_int_dots
    s8_prefill = runtime is not None and runtime.moe_prefill_int_dots
    rf_s8 = runtime is not None and runtime.rf_int_dots
    if runtime is not None and not runtime.rf_fused_sampler:
        rf4, rf8 = ("rf_mlp_q4s8" if runtime.rf_int4_int_dots else "rf_mlp_q4"), ("rf_mlp_q8s8" if rf_s8 else "rf_mlp_q8")
    else:
        rf4, rf8 = "rf_sampler_q4s8", ("rf_sampler_q8s8" if rf_s8 else "rf_sampler_q8")
    q4 = ("moe_stream_q4s8" if int_dots else "moe_stream_q4", "moe_swiglu_gmm_q4s8" if s8_prefill else "moe_swiglu_gmm_q4")
    return {"bfloat16": ("moe_stream", "moe_swiglu_gmm", None),
            "int4": q4 + (rf4,),
            "int4_rf8": q4 + (rf8,),
            "int8": ("moe_stream_q8s8" if int_dots else "moe_stream_q8",
                     "moe_swiglu_gmm_q8s8" if s8_prefill else "moe_swiglu_gmm_q8", rf8),
            "nf4": (None, None, None)}[tier]


def run_slice(torch, cfg, params, device, results: dict, tier="bfloat16", runtime=None, label=None) -> bool:
    """One full-width T2I round at `tier` (in the dot modes of `runtime`, a
    RuntimeConfig; None: the defaults), with every kernel's launch count read
    around it; the kernels of the tier's path must reach their floors (per LLM
    step and layer for the decode kernels, per layer for the prefill one, per
    image token for the fused RF sampler, per Euler step for the per-step
    stack) and the others must not launch."""
    from mingunivision_tpu_torch.config import RuntimeConfig

    runtime = runtime or RuntimeConfig()
    L = cfg.llm.num_hidden_layers
    n_tok = cfg.image_gen.num_image_tokens
    prompt = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, prompt[0], device)
    resident = torch.cuda.memory_allocated()
    label = label or ("slice" if tier == "bfloat16" else f"slice_{tier}")
    (out, sess, total_s), launches, peak = counted_round(
        torch, results, label, lambda: _generate(torch, params, cfg, runtime, device, prompt))

    T = prompt[0].shape[1]
    decode_moe, prefill_moe, sampler = tier_kernels(tier, runtime)
    floors = {decode_moe: L * (n_tok + 1), prefill_moe: L, "decode_attention": L * (n_tok + 1)}
    floors.pop(None, None)
    if sampler is not None:  # the fused sampler once per image token, the per-step stack once per Euler step
        floors[sampler] = n_tok * (1 if runtime.rf_fused_sampler else cfg.rf_head.num_sampling_steps)
    size = math.isqrt(n_tok) * 32  # 32 px per semantic token: 512 px at 256 tokens
    checks = image_checks(out, sess, cfg, T, size) + launch_checks(launches, floors)
    if sampler is not None:  # both CFG rows in one launch
        checks.append((f"{sampler} launches == {floors[sampler]}", launches[sampler] == floors[sampler]))
    t = sess.timings
    print(f"{label} T2I: prompt {T} ids (bucket 128), {L} layers, {tier}, cfg_rows={t.get('cfg_rows')}, "
          f"prefill_ms={t['prefill_ms']:.2f} image_loop_ms={t['image_loop_ms']:.1f} "
          f"ms_per_ar_token={t['image_loop_ms'] / n_tok:.3f} pixel_decode_ms={t['pixel_decode_ms']:.2f} "
          f"total_s={total_s:.3f} resident_gib={resident / 2**30:.3f} max_memory_allocated_gib={peak / 2**30:.3f}")
    if tier not in ("int4_rf8", "nf4"):  # the mixed tier's kernels keep the launches of their own tier's slice
        # a round in another dot mode or RF route (a shorter loop) records only the kernel it varies
        shared = set() if label in ("slice", f"slice_{tier}") else set(tier_kernels(tier)) | {"decode_attention"}
        for name in floors:
            if name not in shared:
                results[name]["launches"] = launches[name]
    return report(label, launches, checks)


def run_understand(torch, cfg, params, device, results: dict, tier="bfloat16", new_tokens: int = 32,
                   int_dots: bool = True, prefill_int_dots: bool = False, prepare: bool = True) -> bool:
    """Image -> text at full width on the tier's model: a 1024-px image (1,024
    patch tokens in a 1,060-id prompt that pads to 1,152) through the MingTok
    encoder, a first-round prefill through the flash kernel and the capacity
    MoE dispatch (image rows routed by the image gate), then greedy text decode
    through the decode kernels. Every kernel of the path must have launched,
    the prefill MoE kernel at least once through the capacity dispatch.

    The attention outputs of the random model are damped first
    (`damp_attention_outputs`): as initialised, its 1,024 image rows come out
    of MingTok nearly parallel, route to the same six experts in every layer
    and overflow the capacity (`--phases routing` shows both); `prepare=False`
    skips that and the LM head's steering, for a second round on the same
    model. int_dots=False runs the round with RuntimeConfig(moe_int_dots=False):
    the exact-dequant decode MoE; prefill_int_dots=True with
    RuntimeConfig(moe_prefill_int_dots=True): the s8 prefill MoE."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import moe_experts_capacity_gmm_exact

    L = cfg.llm.num_hidden_layers
    if prepare:
        steer_text_head(params, cfg)
        damp_attention_outputs(params)
    prompt, pixels = image_prompt(cfg, 1024, 28, seed=21), pixel_values(1024, seed=22)
    fallbacks = moe_experts_capacity_gmm_exact.fallbacks
    label = f"understand_{tier}" + ("" if int_dots else "_exact") + ("_s8" if prefill_int_dots else "")
    runtime = RuntimeConfig(moe_int_dots=int_dots, moe_prefill_int_dots=prefill_int_dots)
    (out, sess, total_s), launches, peak = counted_round(
        torch, results, label, lambda: _generate(torch, params, cfg, runtime, device, prompt, pixels=pixels,
                                                 max_new_tokens=new_tokens))
    fallbacks = moe_experts_capacity_gmm_exact.fallbacks - fallbacks
    t = sess.timings
    T, steps = prompt[0].shape[1], t["text_tokens"]
    decode_moe, prefill_moe, _ = tier_kernels(tier, runtime)
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
    if not int_dots:  # the exact-dequant decode kernel's main path
        results[decode_moe]["launches"] = launches[decode_moe]
    if prefill_int_dots:  # the s8 prefill kernel's main path
        results[prefill_moe]["launches"] = launches[prefill_moe]
    return report(label, launches, checks)


SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PAGE, SERVE_NEW_TOKENS = 16, 2048, 64, 64
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=40, top_p=0.9)


def serve_traffic(cfg, n: int = 24, seed: int = 0):
    """The serving round's requests, built by hand from a numpy seed (no
    tokenizer on the card): n prompts of 32-1,200 ids, the even ones opening
    with one shared 256-id system prompt; every sixth request (4 of 24)
    sampled, the rest greedy. Returns [(ids, sampling kwargs)]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = lambda k: rng.integers(2000, cfg.llm.vocab_size - 1000, k)  # noqa: E731
    system = ids(256)
    out = []
    for i in range(n):
        prompt = np.concatenate([system, ids(int(rng.integers(32, 945)))]) if i % 2 == 0 else ids(int(rng.integers(32, 1201)))
        out.append((prompt, SAMPLED if i % 6 == 5 else {}))
    return out


class StepClock:
    """Wraps an engine's `step`: per decode step that ran, the number of active
    (running, not stalled) slots and the host milliseconds (a step ends in
    the read of its tokens, so the clock covers its device work)."""

    def __init__(self, engine):
        self.engine, self.inner, self.steps = engine, engine.step, []
        engine.step = self

    def __call__(self):
        eng = self.engine
        active = sum(1 for s in eng.slot_req if not getattr(eng, "stalled", {}).get(s, False))
        t0 = time.perf_counter()
        out = self.inner()
        if out:
            self.steps.append((active, (time.perf_counter() - t0) * 1e3))
        return out


def serve_round(worker, traffic, waves: int = 3, clients: int = 4, wave_steps: int = 12, limit_s: float = 300.0):
    """Submit `traffic` through a BatchTextWorker from `clients` threads in
    `waves` waves, wave w once the engine has run w * wave_steps steps (so
    later admissions land mid-flight); wait for every request, for at most
    `limit_s` seconds in all (a request still open then counts as failed).
    Returns (items in traffic order, wall seconds from the first submit to
    the last completion)."""
    import threading

    clock = worker.engine.step
    items = [None] * len(traffic)
    per_wave = len(traffic) // waves
    deadline = time.perf_counter() + limit_s

    def client(k):
        for w in range(waves):
            while len(clock.steps) < w * wave_steps and worker.failure is None and time.perf_counter() < deadline:
                time.sleep(0.002)
            for j in range(w * per_wave + k, (w + 1) * per_wave if w < waves - 1 else len(traffic), clients):
                items[j] = worker.submit(traffic[j][0], SERVE_NEW_TOKENS, traffic[j][1])
        for j in range(k, len(traffic), clients):
            while items[j] is None:
                time.sleep(0.002)
        for j in range(k, len(traffic), clients):
            items[j]["event"].wait(max(0.0, deadline - time.perf_counter()))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return items, time.perf_counter() - t0


@contextlib.contextmanager
def forced_tokens(torch, engine, traffic, want):
    """Teacher forcing of a dense-pool engine for the block: each request of
    `traffic` (told apart by its prompt) is fed the tokens `want[j]`, and at
    every one of them the engine's own argmax is recorded against it. Yields
    records (request j, token index k, argmax == want[j][k], margin of the
    max logit over want[j][k]'s logit, the row's max |logit|)."""
    import numpy as np

    from mingunivision_tpu_torch.engine import batch_engine

    index = {np.asarray(ids, np.int64).tobytes(): j for j, (ids, _) in enumerate(traffic)}
    records, current = [], {}
    add, first_fn, per_slot_fn = engine.add_request, batch_engine.sample_token, batch_engine.sample_token_per_slot

    def note(logits, rows, js, ks):
        forced = torch.tensor([want[j][k] for j, k in zip(js, ks)], device=logits.device)
        lg = logits[rows].float()
        top, arg = lg.max(-1)
        margin = top - lg.gather(1, forced[:, None])[:, 0]
        for rec in zip(js, ks, (arg == forced).tolist(), margin.tolist(), lg.abs().amax(-1).tolist()):
            records.append(rec)
        return forced

    def add_request(ids, *args, **kwargs):
        current["j"] = index[np.asarray(ids, np.int64).reshape(-1).tobytes()]
        return add(ids, *args, **kwargs)

    def first_token(logits, generator=None, **kwargs):  # the admission prefill's token
        return note(logits, [0], [current["j"]], [0])

    def step_tokens(logits, generator=None, **kwargs):
        out = logits.argmax(-1)
        slots = [s for s, req in engine.slot_req.items() if engine.active[s]]
        if slots:
            reqs = [engine.slot_req[s] for s in slots]
            out[slots] = note(logits, slots, [index[np.asarray(r.input_ids, np.int64).tobytes()] for r in reqs],
                              [len(r.tokens) for r in reqs])
        return out

    engine.add_request = add_request
    batch_engine.sample_token, batch_engine.sample_token_per_slot = first_token, step_tokens
    try:
        yield records
    finally:
        batch_engine.sample_token, batch_engine.sample_token_per_slot = first_fn, per_slot_fn
        del engine.add_request


@contextlib.contextmanager
def held_against_plain(torch, entries, return_plain: bool = False):
    """For the block, every call of the named entries runs the kernel and its
    plain version on the same inputs and returns the kernel's output (the
    plain one with `return_plain`); yields name -> [max |kernel - plain| /
    max |plain| per call] over the rows `rows(args)` selects."""
    errs = {name: [] for name in entries}
    saved = []

    class Both:
        """The entry's stand-in: runs both, records the error. A wrapper that
        counts its launches on the name it is patched under counts them on the
        kernel's own function through `launches`."""

        def __init__(self, name, kernel, plain, rows):
            self.name, self.kernel, self.plain, self.rows = name, kernel, plain, rows
            self.__name__ = getattr(kernel, "__name__", name)

        @property
        def launches(self):
            return self.kernel.launches

        @launches.setter
        def launches(self, n):
            self.kernel.launches = n

        def __call__(self, *args, **kwargs):
            out = self.kernel(*args, **kwargs)
            ref = self.plain(*args, **kwargs)
            sel = self.rows(args)
            parts = zip(out, ref) if isinstance(out, tuple) else [(out, ref)]  # a tuple: each part on its own
            errs[self.name].append(max(float((o[sel].float() - r[sel].float()).abs().max()
                                             / r[sel].float().abs().max().clamp_min(1e-30)) if sel.any() else 0.0
                                       for o, r in parts))
            return ref if return_plain else out

    for name, (mod, attr, plain, rows) in entries.items():
        kernel = getattr(mod, attr)
        saved.append((mod, attr, kernel))
        setattr(mod, attr, Both(name, kernel, plain, rows))
    try:
        yield errs
    finally:
        for mod, attr, kernel in saved:
            setattr(mod, attr, kernel)


def run_serve_check(torch, device) -> bool:
    """Where the two serving pools part, on the bf16 full-width model with the
    serve phase's traffic: the paged pool with its paged-attention and
    decode-MoE kernels held against their plain versions at every call, then
    the dense pool fed the paged pool's tokens with its decode-attention and
    decode-MoE kernels held the same way; the forced-token margins by request
    kind (shared system prompt or not) and by token index."""
    import types

    import numpy as np

    from mingunivision_tpu_torch.config import MingUniVisionConfig, RuntimeConfig
    from mingunivision_tpu_torch.engine import batch_engine, paged
    from mingunivision_tpu_torch.engine.session import MingUniVisionSession
    from mingunivision_tpu_torch.models import bailing_moe as bm
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_plain
    from mingunivision_tpu_torch.ops.kernels.paged_attention import paged_gather_attention
    from mingunivision_tpu_torch.serving.server import InferenceServer

    cfg = MingUniVisionConfig()
    params = full_model(torch, cfg, device)
    steer_text_head(params, cfg)
    runtime = RuntimeConfig()
    infer = types.SimpleNamespace(params=params, config=cfg, runtime=runtime, processor=None,
                                  session=MingUniVisionSession(params, cfg, runtime, device=device))
    traffic = serve_traffic(cfg)
    every_row = lambda args: torch.ones(args[1].shape[0], dtype=torch.bool, device=args[1].device)  # noqa: E731
    moe = (bm, "moe_experts_stream", moe_experts_stream_plain, every_row)

    def pool(**kw):
        srv = InferenceServer(infer, batch_slots=SERVE_SLOTS, batch_max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE, **kw)
        StepClock(srv.batch_worker.engine)
        return srv

    srv = pool(prefix_cache=True)
    entries = {"paged_attention": (paged, "paged_decode_attention", paged_gather_attention, lambda a: a[4] > 0),
               "decode_moe": moe}
    try:
        with held_against_plain(torch, entries) as errs:
            items, _ = serve_round(srv.batch_worker, traffic)
    finally:
        srv.batch_worker.stop()
    tokens = [it["req"].tokens for it in items]
    print("serve_check paged pool, kernel vs plain in context (max over calls of max err / max |plain|): "
          + ", ".join(f"{k} {max(v):.3e} over {len(v)} calls" for k, v in errs.items()))
    srv = pool(paged_kv=False)
    entries = {"decode_attention": (batch_engine, "decode_attention", decode_attention_plain,
                                    lambda a: a[3].any(-1)), "decode_moe": moe}
    try:
        with held_against_plain(torch, entries) as errs, \
                forced_tokens(torch, srv.batch_worker.engine, traffic, tokens) as records:
            serve_round(srv.batch_worker, traffic)
    finally:
        srv.batch_worker.stop()
    print("serve_check dense pool fed the paged tokens, kernel vs plain in context: "
          + ", ".join(f"{k} {max(v):.3e} over {len(v)} calls" for k, v in errs.items()))
    for kind, js in (("shared prompt", [j for j in range(len(traffic)) if j % 2 == 0 and j % 6 != 5]),
                     ("own prompt", [j for j in range(len(traffic)) if j % 2 == 1 and j % 6 != 5])):
        rec = [r for r in records if r[0] in js]
        off = [r for r in rec if not r[2]]
        print(f"serve_check forced margins, {kind} ({len(js)} greedy requests): argmax != paged token at "
              f"{len(off)} of {len(rec)} tokens; margin / max |logit| of those: "
              + " ".join(f"j{j}k{k}:{m / sc:.2e}" for j, k, _, m, sc in off[:40]))
    return True


def run_serve(torch, cfg, params, device, results: dict, tier="bfloat16", steered=False) -> bool:
    """Continuous-batching text serving at full width on the tier's model
    (see the module docstring, phase 10). The LM head is steered as in
    `understand` (done there already when that phase ran), so greedy argmax
    gaps are far wider than bf16 rounding and the dense and paged pools, whose
    attention kernels round differently, must agree token for token."""
    import types

    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.engine import batch_engine, paged
    from mingunivision_tpu_torch.engine.session import MingUniVisionSession
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.paged_attention import paged_gather_attention
    from mingunivision_tpu_torch.serving.server import InferenceServer

    if not steered:
        steer_text_head(params, cfg)
    L = cfg.llm.num_hidden_layers
    runtime = RuntimeConfig()
    infer = types.SimpleNamespace(params=params, config=cfg, runtime=runtime, processor=None,
                                  session=MingUniVisionSession(params, cfg, runtime, device=device))
    traffic = serve_traffic(cfg)
    greedy = [j for j, (_, kw) in enumerate(traffic) if not kw]
    step_fn, decode_steps = paged.paged_decode_step, [0]

    def counted_step(*args, **kwargs):
        decode_steps[0] += 1
        return step_fn(*args, **kwargs)

    def pool(**kw):
        srv = InferenceServer(infer, batch_slots=SERVE_SLOTS, batch_max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE, **kw)
        return srv, StepClock(srv.batch_worker.engine)

    checks, label = [], f"serve_{tier}"
    # 1. the paged pool with the prefix cache, through the server's worker
    srv, clock = pool(prefix_cache=True)
    eng = srv.batch_worker.engine
    paged.paged_decode_step = counted_step
    try:
        (items, wall_s), launches, peak = counted_round(torch, results, label, lambda: serve_round(srv.batch_worker,
                                                                                                  traffic))
    finally:
        paged.paged_decode_step = step_fn
        srv.batch_worker.stop()
    pool_gib = (eng.state.k_pages.nbytes + eng.state.v_pages.nbytes) / 2**30
    ok_items = all(it.get("error") is None and it["req"] is not None and it["req"].done for it in items)
    tokens = [it["req"].tokens if ok_items else [] for it in items]
    n_tok = sum(len(t) for t in tokens)
    ttft = sorted((it["t_first"] - it["t_submit"]) * 1e3 for it in items if "t_first" in it)
    decode_moe = tier_kernels(tier)[0]
    steps = decode_steps[0]
    checks += [("24 requests served", ok_items),
               (f"{SERVE_NEW_TOKENS} tokens each", all(len(t) == SERVE_NEW_TOKENS for t in tokens)),
               (f"paged_attention launches {launches['paged_attention']} == {L} x {steps} steps",
                launches["paged_attention"] == L * steps > 0),
               (f"{decode_moe} launches {launches[decode_moe]} == {L} x {steps} steps",
                launches[decode_moe] == L * steps),
               (f"prefix hit tokens {eng.prefix_hit_tokens} >= 256", eng.prefix_hit_tokens >= 256)]
    checks += [(f"{name} launches {n} == 0", n == 0) for name, n in launches.items()
               if name not in ("paged_attention", decode_moe, tier_kernels(tier)[1], "moe_capacity")]
    by_active = {}
    for active, ms in clock.steps:
        by_active.setdefault(active, []).append(ms)
    print(f"{label} paged pool: {len(traffic)} requests ({len(greedy)} greedy, {len(traffic) - len(greedy)} sampled), "
          f"{n_tok} tokens in {wall_s:.3f} s = {n_tok / wall_s:.1f} tokens/s; {steps} engine steps; "
          f"ttft_ms median {statistics.median(ttft):.1f} p90 {ttft[int(0.9 * (len(ttft) - 1))]:.1f}; prefix hit "
          f"{eng.prefix_hit_tokens} / miss {eng.prefix_miss_tokens} tokens; stalls {eng.stalls}; launches per step "
          f"paged_attention {launches['paged_attention'] / max(steps, 1):.1f} {decode_moe} "
          f"{launches[decode_moe] / max(steps, 1):.1f}; pool_gib={pool_gib:.3f} "
          f"max_memory_allocated_gib={peak / 2**30:.3f}")
    print(f"{label} ms per engine step by active slots [active: median ms (steps)]: " + ", ".join(
        f"{a}: {statistics.median(v):.2f} ({len(v)})" for a, v in sorted(by_active.items())))
    results["paged_attention"]["launches"] = launches["paged_attention"]

    # 2. ms per step at exactly 1, 4, 8 and 16 active slots: that many 256-id requests, 8 steps each; then
    # 2 steps under the profiler: device busy ms per step and the paged kernel's part of it
    from torch.profiler import ProfilerActivity, profile

    step_ms, busy = {}, {}
    eng = paged.PagedBatchingEngine(params["llm"], cfg.llm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                                    page_size=SERVE_PAGE, dtype=torch.bfloat16, device=device)
    prompts = np.random.default_rng(2).integers(2000, cfg.llm.vocab_size - 1000, (16, 256))
    for n in (1, 4, 8, 16):
        reqs = [eng.add_request(prompts[j], 12) for j in range(n)]
        times = []
        for _ in range(8):
            t0 = time.perf_counter()
            eng.step()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                eng.step()
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy[n] = (sum(e.self_device_time_total for e in kernels) / 2e3,
                     sum(e.self_device_time_total for e in kernels if any(name in e.key for name in PAGED_KERNEL))
                     / 2e3)
        eng.run_to_completion()
        step_ms[n] = statistics.median(times)
        checks.append((f"{n} requests of 12 tokens", all(len(r.tokens) == 12 for r in reqs)))
    print(f"{label} ms per engine step at 1 / 4 / 8 / 16 active slots (256-id prompts): "
          + " / ".join(f"{step_ms[n]:.2f}" for n in (1, 4, 8, 16)) + "; device busy ms per step (profiled) "
          + " / ".join(f"{busy[n][0]:.3f}" for n in (1, 4, 8, 16)) + ", of which paged attention "
          + " / ".join(f"{busy[n][1]:.3f}" for n in (1, 4, 8, 16)))
    del eng

    # 3. the same requests on the dense pool (its tokens/s). Free-running, its greedy streams part from the
    # paged pool's: the two attention kernels round differently in bf16, and this random model at full depth
    # turns that into another argmax at 4-19% of the tokens (`--phases serve_check`). So the pools are held to
    # the same tokens with the same attention arithmetic: both serve the greedy requests once more (the paged
    # pool without the prefix cache, so every prompt is prefilled alike) with attention taken from the plain
    # versions, each call also run through its kernel and held against them; the tokens must then be equal,
    # request by request, and every kernel call within REL_TOL
    srv, _ = pool(paged_kv=False)
    torch.cuda.reset_peak_memory_stats()
    try:
        d_items, d_wall = serve_round(srv.batch_worker, traffic)
    finally:
        srv.batch_worker.stop()
    d_ok = all(it.get("error") is None and it["req"] is not None and it["req"].done for it in d_items)
    d_tok = sum(len(it["req"].tokens) for it in d_items) if d_ok else 0
    parts = [next((k for k, (a, b) in enumerate(zip(d_items[j]["req"].tokens, tokens[j])) if a != b), len(tokens[j]))
             if d_ok and ok_items else -1 for j in greedy]
    print(f"{label} dense pool: {d_tok} tokens in {d_wall:.3f} s = {d_tok / d_wall:.1f} tokens/s (paged "
          f"{n_tok / wall_s:.1f}); pool_gib={srv.batch_worker.engine.state.k.nbytes * 2 / 2**30:.3f} "
          f"max_memory_allocated_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}; free-running greedy "
          f"streams equal to the paged pool's: {sum(p == SERVE_NEW_TOKENS for p in parts)} of {len(greedy)}, "
          f"first differing token per request {parts}")
    greedy_traffic = [traffic[j] for j in greedy]
    same_arith = {}
    for kind, kw, entry in (
            ("paged", {}, (paged, "paged_decode_attention", paged_gather_attention, lambda a: a[4] > 0)),
            ("dense", {"paged_kv": False},
             (batch_engine, "decode_attention", decode_attention_plain, lambda a: a[3].any(-1)))):
        srv, _ = pool(**kw)
        try:
            with held_against_plain(torch, {kind: entry}, return_plain=True) as errs:
                items_k, _ = serve_round(srv.batch_worker, greedy_traffic)
        finally:
            srv.batch_worker.stop()
        same_arith[kind] = ([it["req"].tokens if it["req"] is not None else None for it in items_k],
                            max(errs[kind], default=float("inf")), len(errs[kind]))
    (p_tok, p_err, p_calls), (d_tok2, d_err, d_calls) = same_arith["paged"], same_arith["dense"]
    equal = [a is not None and a == b for a, b in zip(p_tok, d_tok2)]
    checks += [(f"same attention arithmetic: dense greedy tokens == paged, {sum(equal)} of {len(equal)} requests",
                all(equal)),
               (f"paged_attention in the serving pool within {p_err:.3e} <= {REL_TOL} of its plain version at all "
                f"{p_calls} calls", p_err <= REL_TOL),
               (f"decode_attention in the serving pool within {d_err:.3e} <= {REL_TOL} of its plain version at all "
                f"{d_calls} calls", d_err <= REL_TOL)]

    # 4. a starved paged pool: 40 pages for 16 requests of 65-126 ids (2 pages each at admission, a third
    # while decoding), so slots stall until others finish and resume
    rng = np.random.default_rng(1)
    starved = [(rng.integers(2000, cfg.llm.vocab_size - 1000, int(rng.integers(65, 127))), {}) for _ in range(16)]
    srv, _ = pool(num_pages=40)
    try:
        s_items, s_wall = serve_round(srv.batch_worker, starved, waves=1)
    finally:
        srv.batch_worker.stop()
    s_eng = srv.batch_worker.engine
    s_ok = all(it.get("error") is None and it["req"] is not None and it["req"].done
               and len(it["req"].tokens) == SERVE_NEW_TOKENS for it in s_items)
    checks += [("starved pool: every request finished", s_ok), (f"stalls {s_eng.stalls} >= 1", s_eng.stalls >= 1)]
    print(f"{label} starved paged pool (40 pages x {SERVE_PAGE}, 16 slots): {len(starved)} requests in "
          f"{s_wall:.3f} s, stalls {s_eng.stalls}")
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
    decode_moe, prefill_moe, sampler = tier_kernels(tier)
    floors = {decode_moe: L * (n_tok + 1), prefill_moe: L, "decode_attention": L * (n_tok + 1)}
    if sampler is not None:
        floors[sampler] = n_tok
    checks = image_checks(out, sess, cfg, T, 512, rows=3) + [("T_pad == 384", t["prefill_tokens"] == 384)]
    if sampler is not None:
        checks.append((f"sampler launches == {n_tok}", launches[sampler] == n_tok))
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
          "pixel_decoder": ("generate", "mingtok_pixel_decoder"),
          # the decode MoE (every call: its kernels and, in an older tree, the PyTorch ops that build its list)
          "decode_moe": ("bailing_moe", "moe_experts_stream")}


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


def run_profile(torch, cfg, device, tier="bfloat16", n_tok: int = 16, per_step: bool = False) -> bool:
    """Where the slice's time goes (at `tier`; with `per_step`, the RF head
    through the per-step stack, RuntimeConfig(rf_fused_sampler=False)): one
    round at full width with an n_tok-token
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
    from mingunivision_tpu_torch.models import bailing_moe

    params = full_model(torch, cfg, device, tier)
    prompt = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, prompt[0], device)
    igen = dataclasses.replace(cfg.image_gen, num_image_tokens=n_tok)
    runtime = RuntimeConfig(rf_fused_sampler=not per_step)
    route = "per-step RF stack" if per_step else "fused RF sampler"
    entry, routed = bailing_moe.moe_experts_stream, []

    def note_routing(*args, **kwargs):  # the decode MoE's top-k ids, kept on the device until the round ends
        routed.append(args[2].clone())
        return entry(*args, **kwargs)

    bailing_moe.moe_experts_stream = note_routing
    try:
        _generate(torch, params, cfg, runtime, device, prompt, igen)  # warm-up round
    finally:
        bailing_moe.moe_experts_stream = entry
    unique = [int(torch.unique(idx).numel()) for idx in routed]
    llm = cfg.llm
    h, m = llm.hidden_size, llm.moe_intermediate_size
    # one expert's three tables: bf16; int8 or int4 bytes and their fp32 column scales (NF4 read as int4)
    expert_bytes = {"bfloat16": 3 * h * m * 2, "int8": 3 * h * m + (2 * m + h) * 4}.get(
        tier, 3 * h * m // 2 + (2 * m + h) * 4)
    print(f"profile decode_moe routing (the warm-up round, the same prompt): calls={len(unique)} unique experts per "
          f"call mean {statistics.mean(unique):.2f} min {min(unique)} max {max(unique)}; byte bound per LLM step "
          f"{sum(unique) * expert_bytes / HBM_BYTES_S * 1e3 / (len(unique) / llm.num_hidden_layers):.4f} ms")
    modules = {"generate": generate, "session": session, "bailing_moe": bailing_moe}
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
            out, sess, wall_s = _generate(torch, params, cfg, runtime, device, prompt, igen)
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
    print(f"profile ({tier} slice, {route}, {n_tok} image tokens, profiled): wall_s={wall_s:.3f} device_busy_ms={busy_ms:.1f} "
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
    # decode attention (one launch per layer and decode step) per LLM step: the steps after the prefill
    attn = [e for e in kernels if "decode_split_kernel" in e.key]
    attn_ms, attn_calls = sum(e.self_device_time_total for e in attn) / 1e3, sum(e.count for e in attn)
    print(f"profile decode_attention: launches={attn_calls} device_ms={attn_ms:.3f} "
          f"per_llm_step_ms={attn_ms / max(n_llm - 1, 1):.4f} ({n_llm - 1} decode steps) "
          f"per_launch_us={attn_ms * 1e3 / max(attn_calls, 1):.3f}")
    # the RF head (one call per image token): all device work inside its calls' ranges
    rf_calls, rf_ms = by_stage["rf_sample"]
    print(f"profile rf_sample ({route}): calls={rf_calls} device_ms={rf_ms:.3f} per_image_token_ms={rf_ms / n_tok:.4f}")
    # the decode MoE (one call per layer and decode step): all device work inside its calls' ranges
    moe_calls, moe_ms = by_stage["decode_moe"]
    moe_steps = moe_calls / cfg.llm.num_hidden_layers
    print(f"profile decode_moe: calls={moe_calls} device_ms={moe_ms:.3f} "
          f"per_llm_step_ms={moe_ms / max(moe_steps, 1):.4f} ({moe_steps:g} LLM steps) "
          f"per_call_us={moe_ms * 1e3 / max(moe_calls, 1):.3f}")
    _, sess, wall_s = _generate(torch, params, cfg, runtime, device, prompt, igen)
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
    moe_ms, moe_calls = prefill_moe_device_ms(torch, kernels)
    print(f"profile_understand ({tier}) prefill MoE kernels (rows 2 / 5 / 7c): {moe_ms:.3f} ms device, {moe_calls} "
          f"kernel launches, {moe_ms / busy_ms:.3f} of busy")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile_understand kernel: {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d} calls "
              f"{e.self_device_time_total / max(e.count, 1):9.3f} us/call  {e.key[:90]}")
    return len(out.token_ids) == new_tokens and busy_ms > 0


# ---------------------------------------------------------------------------
# training: the grouped-matmul kernels, the small model's train step, the full-width train steps
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4  # the full-width train phase's depth: a full-depth AdamW state does not fit one card


def tree_paths(tree, prefix=""):
    """The "/"-joined key path of every leaf of a param tree, in `leaves` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{i}")
    else:
        yield prefix


def small_llm(torch, device):
    """The small model's LLM for the train reference, bf16 on `device` from
    seed 2: the full model's structure at hidden 256, 4/2 heads x 64, 8
    experts top-2 of width 128, vocabulary 4,096, one decoder layer (so no
    kernel's rounding can change a later layer's routing). Returns (cfg, params)."""
    import dataclasses

    from mingunivision_tpu_torch.config import BailingMoeConfig
    from mingunivision_tpu_torch.utils.convert import _Init, init_bailing_moe_params

    cfg = dataclasses.replace(BailingMoeConfig(), vocab_size=4096, hidden_size=256, num_hidden_layers=1,
                              num_attention_heads=4, num_key_value_heads=2, head_dim=64, moe_intermediate_size=128,
                              num_experts=8, num_experts_per_tok=2)
    gen = torch.Generator(device=device).manual_seed(2)
    return cfg, init_bailing_moe_params(cfg, _Init(device, torch.bfloat16, gen))


def train_batch(torch, cfg, device):
    """(ids, mask, image_mask) of the train reference from a numpy seed: B 2 x
    T 48 ids (B * T above the decode MoE's 48 rows), the last row's tail
    padded, an image span that the image gate routes."""
    import numpy as np

    B, T = 2, 48
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int64)).to(device)
    mask = torch.ones((B, T), dtype=torch.int32, device=device)
    mask[-1, T - T // 8 :] = 0
    image = torch.zeros((B, T), dtype=torch.bool, device=device)
    image[:, 4 : 4 + T // 4] = True
    return ids, mask, image


def train_entries(torch):
    """The training kernel entries, as `held_against_plain` takes them: the
    differentiable prefill MoE's forward (row 2) and the grouped matmuls of
    its backward (gmm in both orientations, tgmm), every row selected."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm
    from mingunivision_tpu_torch.ops.kernels import moe_swiglu_gmm as msg

    def rows(i):
        return lambda args: torch.ones(args[i].shape[0], dtype=torch.bool, device=args[i].device)

    return {"train_fwd_moe": (msg, "swiglu_gmm_ad_forward", msg.moe_experts_swiglu_gmm_plain, rows(1)),
            "gmm": (moe_gmm, "gmm", moe_gmm.gmm_plain, rows(0)),
            "tgmm": (moe_gmm, "tgmm", moe_gmm.tgmm_plain, rows(2))}


def grouped_library(torch, kind, lhs, rhs, sizes, transpose=False):
    """The yardstick of a grouped matmul: one `torch._grouped_mm` call on bf16
    operands, offsets at the groups' ends. kind: "gmm" (rows x each group's
    matrix, `transpose`: the matrix transposed) or "tgmm" (per group, rows^T x
    grad). Timed only: nothing on the port's path calls it."""
    offs = sizes.cumsum(0).to(torch.int32)
    a = lhs.to(torch.bfloat16)
    if kind == "gmm":
        b = rhs.transpose(1, 2) if transpose else rhs
        return lambda: torch._grouped_mm(a, b, offs=offs)
    b = rhs.to(torch.bfloat16)
    return lambda: torch._grouped_mm(a.t(), b, offs=offs)


# the CUDA kernels of the grouped matmuls by body, as torch.profiler names them
GROUPED_KERNELS = {"wgmma": ("::gmm_wgmma_kernel<",), "mma_sync": ("::gmm_kernel<",),
                   "tgmm_wgmma": ("::tgmm_wgmma_kernel<",), "tgmm_mma_sync": ("::tgmm_kernel<",)}


def kernel_device_ms(torch, fn, iters: int = 10):
    """Device ms per call of `fn` with the host out of the way: a sleep kernel
    holds the stream while the host queues `iters` calls between two CUDA
    events, so the card runs them back to back, and their time over `iters`
    is the card's own (for a wrapper that launches one kernel, the kernel
    alone and its launch gap). Valid only where the card had not reached the
    first event when the host had queued every call; else asked again with a
    4x longer sleep, three times in all, and then None (not measured: the
    case fails; no time is made up)."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # about 10 ms at the H100's clock
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    print(f"kernel_device_ms: the host did not queue {iters} calls within the sleep, three times: not measured")
    return None


def fmt_ms(ms) -> str:
    """A kernel-alone time for a printed line: "not measured" where it could not be taken."""
    return "not measured" if ms is None else f"{ms:.4f}"


def grouped_case(torch, results, name, label, kern, plain, nbytes, ops, library, gmm_args=None,
                 tgmm_args=None) -> bool:
    """One grouped-matmul case (`run_case`), then the body it took and its
    kernel-alone device time. gmm / gmm_trhs (`gmm_args`: lhs, rhs, group
    sizes, out dtype, transposed, the layer's schedule) are timed as the train
    step calls them, with the layer's schedule, and beside that also building
    their own (`own_schedule_ms`); tgmm (`tgmm_args`: lhs, grad, group sizes)
    on the body `tgmm_route` picks. On the wgmma body also the mma_sync body on
    the same operands, through the wrapper's private route argument, and
    tgmm's wgmma body on a grid of one block per item beside its persistent
    one (`grid_ms`), on half the multiprocessors (`half_sms_ms`: twice the time
    where the limit is in each SM, less where it is in L2 or HBM) and on the
    grad rounded to bf16 (`bf16_grad_ms`: no split, half the grad's bytes)."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm

    others = {}
    if gmm_args is not None:
        lhs, rhs, sizes, out_dtype, trans, sched = gmm_args
        route = moe_gmm.gmm_route(lhs, rhs, lhs.shape[1], rhs.shape[1] if trans else rhs.shape[2])
        others["own_schedule"] = lambda: moe_gmm.gmm(lhs, rhs, sizes, out_dtype=out_dtype, transpose_rhs=trans)
        if route == "wgmma":
            others["mma_sync"] = lambda: moe_gmm._launch_gmm(lhs, rhs, sizes, out_dtype, trans, sched, "mma_sync")
    else:
        lhs, grad, sizes = tgmm_args
        E, K, N = sizes.shape[0], lhs.shape[1], grad.shape[1]
        route = moe_gmm.tgmm_route(lhs, grad, K, N, E)
        if route == "wgmma":
            grad_bf16 = grad.to(torch.bfloat16)
            others["mma_sync"] = lambda: moe_gmm._launch_tgmm(lhs, grad, sizes, torch.bfloat16, "mma_sync")
            others["grid"] = lambda: moe_gmm._launch_tgmm(lhs, grad, sizes, torch.bfloat16, "wgmma",
                                                          max_blocks=2**30)  # a block per item
            others["bf16_grad"] = lambda: moe_gmm.tgmm(lhs, grad_bf16, sizes)  # one product per k16 step, half A's bytes
            half = torch.cuda.get_device_properties(lhs.device).multi_processor_count // 2
            others["half_sms"] = lambda: moe_gmm._launch_tgmm(lhs, grad, sizes, torch.bfloat16, "wgmma", max_blocks=half)
    ok = run_case(torch, results, name, label, kern, plain, nbytes, ops, "bf16", library=library, plain_iters=5,
                  others=others)
    case = results[name]["cases"][-1]
    case["route"] = route
    case["device_ms"] = kernel_device_ms(torch, kern)
    ok &= case["device_ms"] is not None
    line = f"route={case['route']} wrapper_ms={case['ms']:.4f} device_ms={fmt_ms(case['device_ms'])}"
    if "own_schedule" in others:
        line += f" (wrapper building its own schedule: {case['own_schedule_ms']:.4f})"
    for body, what in (("mma_sync", "mma_sync body"), ("grid", "wgmma body, one block per item")):
        if body in others:
            case[f"{body}_device_ms"] = kernel_device_ms(torch, others[body])
            ok &= case[f"{body}_device_ms"] is not None
            line += f"; {what}: wrapper_ms={case[f'{body}_ms']:.4f} device_ms={fmt_ms(case[f'{body}_device_ms'])}"
    print(f"kernel {name} [{label.split(';')[0]}]: {line}")
    return ok


def check_train_kernels(torch, results: dict) -> bool:
    """The grouped matmuls of MoE training at the train phase's shape (2 x 1024
    tokens x top-6 = 12,288 rows, 64 experts, h 2048, m 1408), each against
    its plain version within REL_TOL: gmm (fp32 out) on the gate / up and the
    down tables, gmm_trhs (fp32 rows, bf16 out) of the down and gate tables'
    dx, tgmm (bf16 rows, fp32 grad, bf16 out) of the gate and down tables; on
    uniform routing and on routing skewed to 8 experts (56 empty, 2,000
    tokens: 12,000 rows padded into the last group to 12,032); each with the
    body it took and its kernel-alone device time, gmm and gmm_trhs also on the
    mma_sync body; then gmm at widths TMA cannot describe (the mma_sync body).
    Then the differentiable fused MoE on one layer's tables at full width (2 x
    1024 tokens): forward and every grad against the same Function through the
    plain versions at bf16 (within REL_TOL) and printed against fp32."""
    from mingunivision_tpu_torch.config import BailingMoeConfig
    from mingunivision_tpu_torch.ops.kernels import moe_gmm
    from mingunivision_tpu_torch.ops.kernels.moe_gmm import PAD_ROWS

    dev = torch.device("cuda")
    llm = BailingMoeConfig()
    g = torch.Generator(device=dev).manual_seed(8)
    bf = torch.bfloat16
    E, h, m, k = llm.num_experts, llm.hidden_size, llm.moe_intermediate_size, llm.num_experts_per_tok
    w_gate = torch.empty((E, h, m), device=dev, dtype=bf).normal_(0, 0.02, generator=g)
    w_down = torch.empty((E, m, h), device=dev, dtype=bf).normal_(0, 0.02, generator=g)
    routing = moe_cases(torch, g, E, k)[0]
    ok = True
    for label, n_tok, choices in (("2x1024 tok x k=6, uniform", 2048, None),
                                  ("2000 tok x k=6 skewed to 8 experts, padded into the last", 2000,
                                   [0, 5, 9, 17, 33, 34, 50, 63])):
        idx = routing(n_tok, choices)[0]
        A = idx.numel()
        A_pad = -(-A // PAD_ROWS) * PAD_ROWS
        sizes = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(0, idx.reshape(-1),
                                                                          torch.ones_like(idx.reshape(-1)))
        sizes[-1] += A_pad - A
        sizes = sizes.to(torch.int32)
        used = int((sizes > 0).sum())
        pad = torch.arange(A_pad, device=dev)[:, None] < A
        xs = (torch.randn((A_pad, h), device=dev, generator=g) * pad).to(bf)
        a = (torch.randn((A_pad, m), device=dev, generator=g) * pad).to(bf)
        dy = torch.randn((A_pad, h), device=dev, generator=g) * pad
        dg = torch.randn((A_pad, m), device=dev, generator=g) * pad
        sched = moe_gmm.gmm_schedule(sizes, A_pad)  # the layer's schedule, as moe_experts_gmm builds it
        tag = f"{label}: {A_pad} rows, {used} groups"
        # (name, label, kernel, plain, library args, bytes, gmm's operands)
        cases = [
            ("gmm", f"gate/up forward {h}->{m}, {tag}",
             lambda: moe_gmm.gmm(xs, w_gate, sizes, sched=sched),  # noqa: B023
             lambda: moe_gmm.gmm_plain(xs, w_gate, sizes), ("gmm", xs, w_gate, sizes),  # noqa: B023
             A_pad * h * 2 + used * h * m * 2 + A_pad * m * 4, (xs, w_gate, sizes, torch.float32, False, sched)),
            ("gmm", f"down forward {m}->{h}, {tag}", lambda: moe_gmm.gmm(a, w_down, sizes, sched=sched),  # noqa: B023
             lambda: moe_gmm.gmm_plain(a, w_down, sizes), ("gmm", a, w_down, sizes),  # noqa: B023
             A_pad * m * 2 + used * h * m * 2 + A_pad * h * 4, (a, w_down, sizes, torch.float32, False, sched)),
            ("gmm_trhs", f"down dx: fp32 dy x w2^T {h}->{m}, {tag}",
             lambda: moe_gmm.gmm(dy, w_down, sizes, out_dtype=bf, transpose_rhs=True, sched=sched),  # noqa: B023
             lambda: moe_gmm.gmm_plain(dy, w_down, sizes, out_dtype=bf, transpose_rhs=True),  # noqa: B023
             ("gmm", dy, w_down, sizes, True), A_pad * h * 4 + used * h * m * 2 + A_pad * m * 2,
             (dy, w_down, sizes, bf, True, sched)),
            ("gmm_trhs", f"gate dx: fp32 dg x w1^T {m}->{h}, {tag}",
             lambda: moe_gmm.gmm(dg, w_gate, sizes, out_dtype=bf, transpose_rhs=True, sched=sched),  # noqa: B023
             lambda: moe_gmm.gmm_plain(dg, w_gate, sizes, out_dtype=bf, transpose_rhs=True),  # noqa: B023
             ("gmm", dg, w_gate, sizes, True), A_pad * m * 4 + used * h * m * 2 + A_pad * h * 2,
             (dg, w_gate, sizes, bf, True, sched)),
            ("tgmm", f"gate table grad: xs^T dg -> ({E}, {h}, {m}), {tag}",
             lambda: moe_gmm.tgmm(xs, dg, sizes),  # noqa: B023
             lambda: moe_gmm.tgmm_plain(xs, dg, sizes), ("tgmm", xs, dg, sizes),  # noqa: B023
             A_pad * h * 2 + A_pad * m * 4 + E * h * m * 2, (xs, dg, sizes)),
            ("tgmm", f"down table grad: a^T dy -> ({E}, {m}, {h}), {tag}",
             lambda: moe_gmm.tgmm(a, dy, sizes),  # noqa: B023
             lambda: moe_gmm.tgmm_plain(a, dy, sizes), ("tgmm", a, dy, sizes),  # noqa: B023
             A_pad * m * 2 + A_pad * h * 4 + E * h * m * 2, (a, dy, sizes)),
        ]
        for name, case_label, kern, plain, lib_args, nbytes, args in cases:
            ok &= grouped_case(torch, results, name, f"{case_label}; library: torch._grouped_mm, bf16 operands", kern,
                               plain, nbytes, 2.0 * A * h * m, grouped_library(torch, *lib_args),
                               **{"tgmm_args" if name == "tgmm" else "gmm_args": args})
        del xs, a, dy, dg
    # widths TMA cannot describe (rows of 200 bytes): the mma_sync body; no library line (_grouped_mm needs
    # 16-byte rows too)
    sizes = torch.full((8,), 125, dtype=torch.int32, device=dev)
    x_odd = torch.randn((1000, 100), device=dev, generator=g).to(bf)
    w_odd = torch.empty((8, 100, 150), device=dev, dtype=bf).normal_(0, 0.02, generator=g)
    sched = moe_gmm.gmm_schedule(sizes, 1000)
    ok &= grouped_case(torch, results, "gmm", "odd widths 100->150, 1000 rows, 8 groups",
                       lambda: moe_gmm.gmm(x_odd, w_odd, sizes, sched=sched),
                       lambda: moe_gmm.gmm_plain(x_odd, w_odd, sizes),
                       1000 * 100 * 2 + 8 * 100 * 150 * 2 + 1000 * 150 * 4, 2.0 * 1000 * 100 * 150, None,
                       gmm_args=(x_odd, w_odd, sizes, torch.float32, False, sched))
    ok &= check_ad_full_width(torch, w_gate, w_down, g, results)
    del w_gate, w_down
    torch.cuda.empty_cache()
    return ok


def check_ad_full_width(torch, w_gate, w_down, g, results) -> bool:
    """`moe_experts_swiglu_gmm_ad` at full width on one layer's tables (the gate
    table stands for the up table too), 2 x 1024 tokens: the value and every
    grad of the kernel route against the plain route at bf16 (within REL_TOL)
    and against the plain route at fp32 (printed: bf16's own error)."""
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_ad

    E, h = w_gate.shape[0], w_gate.shape[1]
    idx, w = moe_cases(torch, g, E, 6)[0](2048)
    x = torch.randn((2048, h), device=w_gate.device, generator=g).to(torch.bfloat16)
    cot = torch.randn((2048, h), device=w_gate.device, generator=g)
    names = ("y", "gate_proj", "up_proj", "down_proj", "x", "topk_w")

    def run(dtype):
        ex = {"gate_proj": w_gate, "up_proj": w_gate, "down_proj": w_down}
        ex = {n: t.to(dtype).detach().clone().requires_grad_(True) for n, t in ex.items()}
        xx, ww = (t.to(dtype).detach().clone().requires_grad_(True) for t in (x, w))
        y = moe_experts_swiglu_gmm_ad(ex, xx, idx, ww, E)
        y.backward(cot.to(y.dtype))
        torch.cuda.synchronize()
        return [y.detach(), ex["gate_proj"].grad, ex["up_proj"].grad, ex["down_proj"].grad, xx.grad, ww.grad]

    t0 = time.perf_counter()
    kern = run(torch.bfloat16)
    ms = (time.perf_counter() - t0) * 1e3
    with plain_versions(("train_moe",)):
        plain, ref = run(torch.bfloat16), run(torch.float32)
    checks, errs = [], {}
    for name, a, b, r in zip(names, kern, plain, ref):
        ok, err, rel = compare(torch, a, b)
        rel32 = float((a.float() - r).abs().max() / r.abs().max().clamp_min(1e-30))
        errs[name] = {"vs_plain_bf16": rel, "vs_plain_fp32": rel32}
        checks.append((f"{name} {rel:.3e} of max vs plain bf16 (fp32: {rel32:.3e})", ok))
    results.setdefault("moe_swiglu_gmm_ad", {})["full_width"] = errs
    print(f"kernel moe_swiglu_gmm_ad [2x1024 tok x k=6, one layer's tables, forward + backward {ms:.1f} ms "
          f"(first call)]: " + "; ".join(f"{label}={'ok' if p else 'MISMATCH'}" for label, p in checks))
    return all(p for _, p in checks)


def check_flash_vit_train_kernels(torch, results: dict) -> bool:
    """The ViT flash attention's backward kernels of MingTok training at the
    pixel decoder's shape (16 heads x 1024 tokens x 64, batch 2 and 8): dK / dV
    and dQ against their plain versions on the kernel forward's residuals
    (the forward with residuals is held in `flash_vit_cases`), within REL_TOL,
    each with its kernel-alone device time (`kernel_device_ms`; a case it
    cannot take fails) and achieved TFLOP/s. The library time of the backward
    kernels is one `torch.autograd.grad` through `scaled_dot_product_attention`
    on the same q, k, v and dO (its whole backward: the work of the pair);
    timed only. Beside it, the whole backward as `FlashViTAttention.backward`
    runs it (delta, then both wrappers), through the wrappers and alone, with
    SDPA's whole backward timed again in turn; recorded in the dQ case's
    `pair`."""
    from mingunivision_tpu_torch.ops.kernels import flash

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, N, D = 16, 1024, 64
    scale = D**-0.5
    ok = True
    for B in (2, 8):
        q, k, v, do = (torch.randn((B, H, N, D), device=dev, generator=g).to(torch.bfloat16) for _ in range(4))
        numel, rows, pair_ops = q.numel(), B * H * N, 2.0 * N * N * D * H * B  # one N x N x D product
        label = f"{B}x{H}x{N}x{D} head-major"
        out, lse = flash.flash_vit_attention_lse(q, k, v, scale=scale)
        delta = flash.flash_vit_delta(out, do)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = sdpa(*leaves)
        library = lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True)  # noqa: B023, E731
        args = (q, k, v, lse, do, delta)
        ok &= run_case(torch, results, "flash_vit_bwd_dkv", f"{label}; library: SDPA's whole backward",
                       lambda: flash.flash_vit_bwd_dkv(*args, scale=scale),  # noqa: B023
                       lambda: flash.flash_vit_bwd_dkv_plain(*args, scale=scale),  # noqa: B023
                       6 * numel * 2 + 2 * rows * 4, 4 * pair_ops, "bf16", library=library, plain_iters=5)
        ok &= run_case(torch, results, "flash_vit_bwd_dq", f"{label}; library: SDPA's whole backward",
                       lambda: flash.flash_vit_bwd_dq(*args, scale=scale),  # noqa: B023
                       lambda: flash.flash_vit_bwd_dq_plain(*args, scale=scale),  # noqa: B023
                       5 * numel * 2 + 2 * rows * 4, 3 * pair_ops, "bf16", library=library, plain_iters=5)
        dkv, dq = results["flash_vit_bwd_dkv"]["cases"][-1], results["flash_vit_bwd_dq"]["cases"][-1]
        for case, kern, ops in ((dkv, lambda: flash.flash_vit_bwd_dkv(*args, scale=scale), 4 * pair_ops),  # noqa: B023
                                (dq, lambda: flash.flash_vit_bwd_dq(*args, scale=scale), 3 * pair_ops)):  # noqa: B023
            case["device_ms"] = kernel_device_ms(torch, kern)
            ok &= case["device_ms"] is not None
            case["device_tflops"] = ops / case["device_ms"] / 1e9 if case["device_ms"] else None

        def function_backward():  # FlashViTAttention.backward's work on a contiguous bf16 dO
            d = flash.flash_vit_delta(out, do)  # noqa: B023
            dk_dv = flash.flash_vit_bwd_dkv(q, k, v, lse, do, d, scale=scale)  # noqa: B023
            return flash.flash_vit_bwd_dq(q, k, v, lse, do, d, scale=scale), *dk_dv  # noqa: B023

        pair = {"function_ms": cuda_ms(torch, function_backward), "library_ms": cuda_ms(torch, library),
                "function_device_ms": kernel_device_ms(torch, function_backward),
                "library_device_ms": kernel_device_ms(torch, library)}
        ok &= pair["function_device_ms"] is not None and pair["library_device_ms"] is not None
        pair["bound_ms"] = bound(7 * numel * 2 + 2 * rows * 4, 5 * pair_ops, "bf16")[0]
        dq["pair"] = pair
        tflops = ", ".join(f"{n} {fmt_ms(c['device_ms'])} ms alone, {c['device_tflops'] or 0:.1f} TFLOP/s"
                           for n, c in (("dkv", dkv), ("dq", dq)))
        print(f"kernel flash_vit_bwd pair [{label}]: ms={dkv['ms'] + dq['ms']:.4f} ({tflops}); the whole backward "
              f"as the Function runs it (delta + both wrappers): ms={pair['function_ms']:.4f} "
              f"device_ms={fmt_ms(pair['function_device_ms'])}; SDPA's whole backward: ms={pair['library_ms']:.4f} "
              f"device_ms={fmt_ms(pair['library_device_ms'])}; bound_ms={pair['bound_ms']:.4f} (operations: 10 N^2 "
              f"D per head and image, {pair['bound_ms'] / B:.4f} per image)")
        del q, k, v, do, out, lse, delta, leaves, lib_out, library, args, function_backward
    torch.cuda.empty_cache()
    return ok


def small_mingtok(torch, device, tier: str, dtype):
    """The MingTok of the train references on `device`, params in `dtype` from
    seed 5: 256-px images at patch 16, width 128 and 2 heads of 64 in each
    ViT, depth 2, latents of 8 channels; the pixel decoder at patch 8 on 1,024
    tokens (so its reduced tiers reach the flash kernel), at `tier`. Returns
    (cfg, params)."""
    import dataclasses

    from mingunivision_tpu_torch.config import (
        MingTokConfig,
        PixelDecoderConfig,
        SemanticDecoderConfig,
        ViTEncoderConfig,
    )
    from mingunivision_tpu_torch.utils.convert import _Init, init_mingtok_params

    cfg = MingTokConfig(
        encoder=ViTEncoderConfig(img_size=256, patch_size=16, embed_dim=128, depth=2, num_heads=2, out_dim=8),
        semantic_decoder=SemanticDecoderConfig(in_dim=8, embed_dim=128, depth=2, num_heads=2, patch_size=16),
        pixel_decoder=PixelDecoderConfig(embed_dim=128, depth=2, num_heads=2, patch_size=8, matmul_precision=tier),
        scaling_factor=2.0, mean=0.5)
    params = init_mingtok_params(cfg, _Init(device, dtype, torch.Generator(device=device).manual_seed(5)))
    return cfg, params


def mingtok_train_entries(torch):
    """MingTok training's kernel entries, as `held_against_plain` takes them:
    the ViT flash forward with residuals and the two backward kernels."""
    from mingunivision_tpu_torch.ops.kernels import flash

    every = lambda args: torch.ones(args[0].shape[0], dtype=torch.bool, device=args[0].device)  # noqa: E731
    return {"flash_vit_fwd_lse": (flash, "flash_vit_attention_lse", flash.flash_vit_attention_lse_plain, every),
            "flash_vit_bwd_dkv": (flash, "flash_vit_bwd_dkv", flash.flash_vit_bwd_dkv_plain, every),
            "flash_vit_bwd_dq": (flash, "flash_vit_bwd_dq", flash.flash_vit_bwd_dq_plain, every)}


def run_reference_mingtok(torch, device, tier: str = "bf16", remat: bool = False) -> bool:
    """The small MingTok's `mingtok_train_loss` backward (B 1, a teacher, the
    pixel decoder at `tier` on 1,024 tokens, `remat`) through the kernels, bf16
    params and compute, against the plain entries in fp32 (fp32 params and
    compute, the pixel decoder at "high": plain attention), the reference, on
    the same weights and images. The loss and every leaf's grad of the kernel
    route may differ from the reference by at most twice the plain bf16
    route's own error plus 1e-2 of the reference's maximum (the plain bf16
    route: the same call with the flash entries swapped for their plain
    versions); every call of an entry (`mingtok_train_entries`) is held against
    its plain version on the same inputs within REL_TOL, and every entry must
    have been called once per pixel-decoder layer (the forward twice with
    remat)."""
    import dataclasses

    import numpy as np

    from mingunivision_tpu_torch.engine.train import mingtok_train_loss, pixel_tier_context
    from mingunivision_tpu_torch.utils.pytree import leaves, tree_map

    cfg, params = small_mingtok(torch, device, tier, torch.bfloat16)
    rng = np.random.default_rng(6)
    S = cfg.encoder.img_size
    images = torch.from_numpy(np.tanh(rng.standard_normal((1, 3, S, S))).astype(np.float32)).to(device)
    teacher = torch.from_numpy(rng.standard_normal((1, (S // 16) ** 2, cfg.feature_dim)).astype(np.float32))
    teacher = teacher.to(device)
    ref_cfg = dataclasses.replace(cfg, pixel_decoder=dataclasses.replace(cfg.pixel_decoder, matmul_precision="high"))

    def loss_and_grads(tree, c, dtype):
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)
        loss, _ = mingtok_train_loss(tree, c, images, teacher, compute_dtype=dtype, remat=remat)
        with pixel_tier_context(c):
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves(tree)]
        return [loss.detach().float().cpu()] + [gr.float().cpu() for gr in grads]

    with held_against_plain(torch, mingtok_train_entries(torch)) as errs:
        kern = loss_and_grads(params, cfg, torch.bfloat16)
    with plain_versions(("flash_vit_train",)):
        plain = loss_and_grads(params, cfg, torch.bfloat16)
    ref = loss_and_grads(as_f32(params), ref_cfg, torch.float32)
    depth = cfg.pixel_decoder.depth
    want = {"flash_vit_fwd_lse": (2 if remat else 1) * depth, "flash_vit_bwd_dkv": depth, "flash_vit_bwd_dq": depth}
    checks = [(f"{name} {len(v)} calls == {want[name]}, within {max(v, default=0):.3e} <= {REL_TOL} of its plain "
               f"version", len(v) == want[name] and max(v) <= REL_TOL) for name, v in errs.items()]
    worst, worst_ratio = "", 0.0
    for path, a, p, r in zip(["loss"] + list(tree_paths(params)), kern, plain, ref):
        err_k, err_p = float((a - r).abs().max()), float((p - r).abs().max())
        tol = 2 * err_p + 1e-2 * float(r.abs().max())
        ratio = err_k / max(tol, 1e-30)
        if ratio >= worst_ratio:
            worst, worst_ratio = f"{path} err {err_k:.3e} <= {tol:.3e} (plain bf16 {err_p:.3e})", ratio
        if not (bool(torch.isfinite(a).all()) and err_k <= tol):
            checks.append((f"{path} err vs fp32 {err_k:.3e} <= {tol:.3e} (plain bf16 err {err_p:.3e})", False))
    checks.append((f"loss and {len(kern) - 1} grads within twice the plain bf16 error + 1e-2 of max (closest: "
                   f"{worst})", worst_ratio <= 1.0))
    print(f"reference train_mingtok [{tier}{', remat' if remat else ''}] (small MingTok's mingtok_train_loss "
          f"backward on the {device.type}: kernels bf16 vs plain fp32; loss {float(kern[0]):.5f} / "
          f"{float(ref[0]):.5f}): " + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks))
    return all(p for _, p in checks)


def run_reference_train(torch, device) -> bool:
    """The small model's `lm_loss` train step (its backward) through the
    kernels (bf16) and through their plain versions in fp32, the reference, on
    the same weights and batch (B 2 x T 48, the router aux losses on). The loss
    and every leaf's grad of the kernel route may differ from the reference by
    at most twice the plain bf16 route's own error plus 1e-2 of the
    reference's maximum; every call of a training kernel entry (`train_entries`:
    the fused forward, gmm, tgmm) is held against its plain version on the same
    inputs within REL_TOL; every entry must have been called."""
    from mingunivision_tpu_torch.engine.train import lm_loss
    from mingunivision_tpu_torch.utils.pytree import leaves, tree_map

    cfg, params = small_llm(torch, device)
    ids, mask, image = train_batch(torch, cfg, device)

    def loss_and_grads(tree):
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)
        loss = lm_loss(tree, cfg, ids, mask, image, balance_alpha=0.01, z_alpha=1e-4)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves(tree)]
        return [loss.detach().float().cpu()] + [gr.float().cpu() for gr in grads]

    with held_against_plain(torch, train_entries(torch)) as errs:
        kern = loss_and_grads(params)
    with plain_versions(("train_moe",)):
        ref = loss_and_grads(as_f32(params))
        plain = loss_and_grads(params)
    checks = [(f"{name} within {max(v):.3e} <= {REL_TOL} of its plain version at all {len(v)} calls",
               bool(v) and max(v) <= REL_TOL) for name, v in errs.items()]
    worst, worst_ratio = "", 0.0
    for path, a, p, r in zip(["loss"] + list(tree_paths(params)), kern, plain, ref):
        err_k, err_p = float((a - r).abs().max()), float((p - r).abs().max())
        tol = 2 * err_p + 1e-2 * float(r.abs().max())
        ratio = err_k / max(tol, 1e-30)
        if ratio >= worst_ratio:
            worst, worst_ratio = f"{path} err {err_k:.3e} <= {tol:.3e} (plain bf16 {err_p:.3e})", ratio
        if not (bool(torch.isfinite(a).all()) and err_k <= tol):
            checks.append((f"{path} err vs fp32 {err_k:.3e} <= {tol:.3e} (plain bf16 err {err_p:.3e})", False))
    checks.append((f"loss and {len(kern) - 1} grads within twice the plain bf16 error + 1e-2 of max (closest: "
                   f"{worst})", worst_ratio <= 1.0))
    print(f"reference train (small model's lm_loss backward on the {device.type}: kernels bf16 vs plain fp32; loss "
          f"{float(kern[0]):.5f} / {float(ref[0]):.5f}): "
          + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks))
    return all(p for _, p in checks)


def full_train_model(torch, device):
    """The train phase's LLM: `MingUniVisionConfig()`'s at full width cut to
    TRAIN_LAYERS decoder layers, random bf16 weights from seed 0 on the
    device. Returns (the MingUniVisionConfig with that LLM, the LLM's params)."""
    import dataclasses

    from mingunivision_tpu_torch.config import MingUniVisionConfig
    from mingunivision_tpu_torch.utils.convert import _Init, init_bailing_moe_params

    base = MingUniVisionConfig()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(base.llm, num_hidden_layers=TRAIN_LAYERS))
    init = _Init(device, torch.bfloat16, torch.Generator(device=device).manual_seed(0))
    return cfg, init_bailing_moe_params(cfg.llm, init)


def train_launch_checks(launches, layers: int, steps: int):
    """Per layer and step: the fused forward once, gmm (the recompute), gmm_trhs
    and tgmm three times each, every gmm, gmm_trhs and tgmm on the wgmma body;
    no other kernel."""
    want = {"moe_swiglu_gmm": layers * steps, "gmm": 3 * layers * steps, "gmm_trhs": 3 * layers * steps,
            "tgmm": 3 * layers * steps, "gmm_wgmma": 3 * layers * steps, "gmm_trhs_wgmma": 3 * layers * steps,
            "tgmm_wgmma": 3 * layers * steps}
    return ([(f"{name} launches {launches[name]} == {n} ({n // steps} per step)", launches[name] == n)
             for name, n in want.items()]
            + [(f"{name} launches {n} == 0", n == 0) for name, n in launches.items() if name not in want and n])


# the autograd nodes that carry each layer's gradient to its depth-stacked leaf: per-layer indexing's
# (one full-size zero gradient per layer and leaf, summed at the leaf) and layer_views' (one stack per leaf)
GRAD_PATH_NODES = ("SelectBackward0", "UnbindBackward0", "AccumulateGrad")


def grad_path_ms(prof) -> dict:
    """Device ms of the kernels that the GRAD_PATH_NODES of a profiled step
    launched, by node and by kernel kind (fill, add, stack, copy, other)."""
    nodes = {node: 0.0 for node in GRAD_PATH_NODES}
    kinds = {kind: 0.0 for kind in ("fill", "add", "stack", "copy", "other")}

    def kind(name):
        low = name.lower()
        return next((k for k, key in (("fill", "fill"), ("stack", "catarray"), ("add", "add"), ("copy", "copy"))
                     if key in low), "other")

    def walk(e):
        for k in e.kernels:
            kinds[kind(k.name)] += k.duration / 1e3
        for child in e.cpu_children:
            walk(child)

    for e in prof.events():
        if e.name.startswith("autograd::engine::evaluate_function: "):
            node = next((n for n in GRAD_PATH_NODES if e.name.endswith(n)), None)
            if node is not None:
                nodes[node] += e.device_time_total / 1e3
                walk(e)
    return {"total_ms": sum(nodes.values()), "by_node_ms": nodes, "by_kind_ms": kinds}


def profile_train_step(torch, state, step, record: dict, label: str = "train lm profile"):
    """One more LM step under torch.profiler, the loss (`lm_loss`) in a profiler
    range: device ms of the forward, of the optimizer update (the span of
    PyTorch's own `Optimizer.step` range on the device), of the backward (the
    rest of the step's kernel time), the device busy share of the step's wall
    time, the top kernels, the grouped matmuls' device ms per call and share,
    the routing they see (each layer's group sizes, kept from its schedule
    as the step builds it), and the device ms of the way the layers'
    gradients take to the stacked leaves (`grad_path_ms`). Returns the state."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mingunivision_tpu_torch.engine import train as train_mod
    from mingunivision_tpu_torch.ops.kernels import moe_gmm

    loss_fn, schedule, group_sizes = train_mod.lm_loss, moe_gmm.gmm_schedule, []

    def ranged(*args, **kwargs):
        with record_function("train_forward"):
            return loss_fn(*args, **kwargs)

    def kept(sizes, rows):
        group_sizes.append(sizes.clone())
        return schedule(sizes, rows)

    train_mod.lm_loss, moe_gmm.gmm_schedule = ranged, kept
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, loss = step(state)
            float(loss)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        train_mod.lm_loss, moe_gmm.gmm_schedule = loss_fn, schedule
    cuda = torch.autograd.DeviceType.CUDA

    def annotation(e):  # a profiler range, not a kernel (events have `name`, their averages `key`)
        name = getattr(e, "name", None) or e.key
        return getattr(e, "is_user_annotation", False) or name == "train_forward" or name.startswith("Optimizer.")

    device_events = [e for e in prof.events() if e.device_type == cuda]
    kernels = [e for e in device_events if not annotation(e)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    fwd_ms = stage_device_ms(device_events, ("train_forward",))["train_forward"][1]
    opt_ms = sum(e.time_range.elapsed_us() for e in device_events if e.name.startswith("Optimizer.step")) / 1e3
    path = grad_path_ms(prof)
    record["profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "forward_ms": fwd_ms, "optimizer_ms": opt_ms,
                         "backward_ms": busy_ms - fwd_ms - opt_ms, "grad_path": path}
    print(f"{label} (one step, profiled): wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} "
          f"busy_share={busy_ms / wall_ms:.3f}; device ms: forward {fwd_ms:.1f}, backward {busy_ms - fwd_ms - opt_ms:.1f}, "
          f"optimizer {opt_ms:.1f} (its span); device events {len(kernels)}")
    print(f"{label} gradient path to the stacked leaves: {path['total_ms']:.2f} ms device, "
          f"{path['total_ms'] / busy_ms:.3f} of busy; by node: "
          + ", ".join(f"{k} {v:.2f}" for k, v in path["by_node_ms"].items()) + "; by kernel: "
          + ", ".join(f"{k} {v:.2f}" for k, v in path["by_kind_ms"].items()))
    top = [e for e in prof.key_averages() if e.device_type == cuda and not annotation(e)]
    fused_ms, fused_calls = prefill_moe_device_ms(torch, top)
    record["profile"]["fused_forward_ms"] = fused_ms
    print(f"{label} fused prefill MoE forward (row 2): {fused_ms:.3f} ms device, {fused_calls} kernel launches, "
          f"{fused_ms / busy_ms:.3f} of busy")
    for e in sorted(top, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"{label} kernel: {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} calls "
              f"{e.self_device_time_total / max(e.count, 1):10.3f} us/call  {e.key[:90]}")
    grouped = {}  # kernel body and types -> (device ms, calls)
    for e in top:
        body = next((b for b, names in GROUPED_KERNELS.items() if any(n in e.key for n in names)), None)
        if body is not None:
            types = e.key[e.key.index("<") + 1:e.key.index(">")]
            grouped[f"{body}<{types}>"] = (e.self_device_time_total / 1e3, e.count)
    grouped_ms = sum(ms for ms, _ in grouped.values())
    sizes = torch.stack(group_sizes).long().cpu() if group_sizes else torch.zeros((0, 1), dtype=torch.long)
    routing = {"experts_used": (sizes > 0).sum(1).tolist(), "largest_group": sizes.max(1).values.tolist(),
               "row_tiles": (-(-sizes // moe_gmm.TILE_ROWS)).sum(1).tolist()}
    record["profile"].update(grouped_matmul_ms=grouped_ms, grouped_matmul_share=grouped_ms / busy_ms,
                             grouped_per_call_ms={k: ms / n for k, (ms, n) in grouped.items()}, routing=routing)
    print(f"{label} grouped matmuls: {grouped_ms:.2f} ms device, {grouped_ms / busy_ms:.3f} of busy; per "
          f"call: " + "; ".join(f"{k} {ms / n:.4f} ms x {n}" for k, (ms, n) in grouped.items()))
    print(f"{label} routing (per layer): experts used {routing['experts_used']}, largest group "
          f"{routing['largest_group']} rows, row tiles {routing['row_tiles']} (uniform: 64 experts, 192 rows, 128 "
          f"tiles)")
    return state


def run_train(torch, device, results: dict) -> bool:
    """Training on one card at the 16B-A3B width cut to TRAIN_LAYERS layers.
    LM step: B 2 x T 1024 of the synthetic token stream, make_optimizer(1e-3),
    aux balance 0.01 and z 1e-4; one warm-up step, then 3 timed steps on the
    same batch: every loss finite and the last below the first, ms per step
    (synchronised, median), tokens/s, resident and peak memory, launches per
    step. Image-generation step: B 2 x (32 text ids + 256 image positions),
    the full RF head, vis_head and linear_proj, random MingTok features and
    latents, make_optimizer(1e-5) (at 1e-4 the first AdamW step of the random
    3072-wide head raised its loss 16-fold), 2 steps: loss, ms per step, peak
    memory, launches."""
    import numpy as np

    from mingunivision_tpu_torch.engine.train import (
        TokenStream,
        TrainState,
        make_image_gen_train_step,
        make_optimizer,
        make_train_step,
    )
    from mingunivision_tpu_torch.utils.pytree import leaves

    t0 = time.perf_counter()
    cfg, llm_params = full_train_model(torch, device)
    llm = cfg.llm
    n_params = sum(t.numel() for t in leaves(llm_params))
    state = TrainState.create(llm_params, make_optimizer(1e-3))
    step = make_train_step(llm, balance_alpha=0.01, z_alpha=1e-4)
    B, T = 2, 1024
    ids = torch.from_numpy(TokenStream(None, llm.vocab_size, seed=0).batch(B, T).astype(np.int64)).to(device)
    mask = torch.ones((B, T), dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    print(f"train: {n_params / 1e9:.3f} B params bf16 ({TRAIN_LAYERS} layers at full width) in "
          f"{time.perf_counter() - t0:.1f} s")
    losses, step_ms = [], []

    def lm_steps():
        nonlocal state
        for _ in range(4):
            t1 = time.perf_counter()
            state, loss = step(state, ids, mask)
            losses.append(float(loss))  # reads the loss: the step is synchronised
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)

    _, launches, peak = counted_round(torch, results, "train_lm", lm_steps)
    resident = torch.cuda.memory_allocated()
    ms = statistics.median(step_ms[1:])
    for name in ("gmm", "gmm_trhs", "tgmm"):
        results.setdefault(name, {})["launches"] = launches[name]
    checks = [(f"losses {', '.join(f'{v:.4f}' for v in losses)} finite", all(np.isfinite(losses))),
              (f"last {losses[-1]:.4f} < first {losses[0]:.4f}", losses[-1] < losses[0])]
    checks += train_launch_checks(launches, TRAIN_LAYERS, 4)
    print(f"train lm: B={B} T={T} ms/step {ms:.1f} (steps {', '.join(f'{v:.1f}' for v in step_ms)}; warm-up first) "
          f"tokens/s {B * T / ms * 1e3:.1f}; resident {resident / 2**30:.3f} GiB, peak {peak / 2**30:.3f} GiB")
    ok = report("train lm", launches, checks)
    results["train"] = {"lm": {"losses": losses, "step_ms": step_ms, "ms_per_step": ms, "tokens_per_s": B * T / ms * 1e3,
                               "resident_gib": resident / 2**30, "peak_gib": peak / 2**30, "params_b": n_params / 1e9}}
    state = profile_train_step(torch, state, lambda st: step(st, ids, mask), results["train"]["lm"])
    # the same steps with the layers read by per-layer indexing, as quantized trees read them and as the train
    # forward did before it took layer_views (one full-size zero gradient per layer and leaf): step time, peak
    # memory and the gradient path beside the above, on the same weights and batch
    from mingunivision_tpu_torch.models import bailing_moe

    float_tree, idx_ms = bailing_moe.is_float_tree, []
    bailing_moe.is_float_tree = lambda tree: False
    try:
        torch.cuda.reset_peak_memory_stats()
        for _ in range(4):
            t1 = time.perf_counter()
            state, loss = step(state, ids, mask)
            float(loss)
            torch.cuda.synchronize()
            idx_ms.append((time.perf_counter() - t1) * 1e3)
        idx_peak = torch.cuda.max_memory_allocated()
        indexed = {"step_ms": idx_ms, "ms_per_step": statistics.median(idx_ms[1:]), "peak_gib": idx_peak / 2**30}
        state = profile_train_step(torch, state, lambda st: step(st, ids, mask), indexed,
                                   "train lm profile, per-layer indexing")
    finally:
        bailing_moe.is_float_tree = float_tree
    results["train"]["lm"]["indexed_layers"] = indexed
    print(f"train lm, per-layer indexing: ms/step {indexed['ms_per_step']:.1f} (steps "
          f"{', '.join(f'{v:.1f}' for v in idx_ms)}) tokens/s {B * T / indexed['ms_per_step'] * 1e3:.1f}; peak "
          f"{indexed['peak_gib']:.3f} GiB (layer_views: {ms:.1f} ms, {peak / 2**30:.3f} GiB)")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # the image-generation step on the same LLM weights (after the LM steps) with the full RF head
    from mingunivision_tpu_torch.utils.convert import (
        _Init,
        init_linear_proj_params,
        init_rf_head_params,
        init_vis_head_params,
    )

    init = _Init(device, torch.bfloat16, torch.Generator(device=device).manual_seed(1))
    params = {"llm": llm_params, "rf_head": init_rf_head_params(cfg.rf_head, init),
              "vis_head": init_vis_head_params(llm.hidden_size, cfg.rf_head.z_channels, init),
              "linear_proj": init_linear_proj_params(cfg.mingtok.feature_dim, llm.hidden_size, cfg.mlp_depth, init)}
    randomize_adaln(params, init.gen)
    state = TrainState.create(params, make_optimizer(1e-5))
    step = make_image_gen_train_step(llm, cfg.rf_head)
    g = torch.Generator(device=device).manual_seed(3)
    Tt, N = 32, cfg.image_gen.num_image_tokens
    text_ids = torch.randint(0, llm.vocab_size, (B, Tt), device=device, generator=g)
    text_mask = torch.ones((B, Tt), dtype=torch.int32, device=device)
    sem = torch.randn((B, N, cfg.mingtok.feature_dim), device=device, generator=g).to(torch.bfloat16)
    latents = torch.randn((B, N, cfg.rf_head.target_channels), device=device, generator=g).to(torch.bfloat16)
    img_losses, img_ms = [], []

    def image_steps():
        nonlocal state
        for _ in range(2):
            t1 = time.perf_counter()
            state, loss = step(state, text_ids, text_mask, sem, latents, g)
            img_losses.append(float(loss))
            torch.cuda.synchronize()
            img_ms.append((time.perf_counter() - t1) * 1e3)

    _, launches, peak = counted_round(torch, results, "train_image_gen", image_steps)
    checks = [(f"losses {', '.join(f'{v:.4f}' for v in img_losses)} finite", all(np.isfinite(img_losses)))]
    checks += train_launch_checks(launches, TRAIN_LAYERS, 2)
    n_all = sum(t.numel() for t in leaves(params))
    print(f"train image_gen: B={B} x ({Tt} text + {N} image) positions, {n_all / 1e9:.3f} B params; ms/step "
          f"{', '.join(f'{v:.1f}' for v in img_ms)} (the first warms up); peak {peak / 2**30:.3f} GiB")
    ok &= report("train image_gen", launches, checks)
    results["train"]["image_gen"] = {"losses": img_losses, "step_ms": img_ms, "peak_gib": peak / 2**30,
                                     "params_b": n_all / 1e9}
    del state, step, params, llm_params
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def mingtok_round_checks(launches, tier: str, steps: int, remat: bool):
    """Per step: the flash forward with residuals once per pixel-decoder layer
    (twice with remat: the recompute), each on the wgmma body, dK / dV and dQ
    once each; none at "high"; no other kernel."""
    per = 24 if tier != "high" else 0
    want = {"flash_vit": (2 if remat else 1) * per * steps, "flash_vit_bwd_dkv": per * steps,
            "flash_vit_bwd_dq": per * steps}
    return ([(f"{name} launches {launches[name]} == {n} ({n // steps} per step)", launches[name] == n)
             for name, n in want.items()]
            + [(f"{name} launches {n} == 0", n == 0) for name, n in launches.items() if name not in want and n])


def profile_mingtok_step(torch, state, step, record: dict):
    """One more MingTok step under torch.profiler, `mingtok_train_loss` in a
    profiler range: device ms of the forward, the backward and the AdamW update
    (PyTorch's `Optimizer.step` span), the flash kernels' device ms (forward
    with residuals, dK / dV, dQ), the busy share of the step's wall time, and
    the top kernels. Returns the state."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mingunivision_tpu_torch.engine import train as train_mod

    loss_fn = train_mod.mingtok_train_loss

    def ranged(*args, **kwargs):
        with record_function("train_forward"):
            return loss_fn(*args, **kwargs)

    train_mod.mingtok_train_loss = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, (loss, _) = step(state)
            float(loss)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        train_mod.mingtok_train_loss = loss_fn
    cuda = torch.autograd.DeviceType.CUDA

    def annotation(e):
        name = getattr(e, "name", None) or e.key
        return getattr(e, "is_user_annotation", False) or name == "train_forward" or name.startswith("Optimizer.")

    device_events = [e for e in prof.events() if e.device_type == cuda]
    kernels = [e for e in device_events if not annotation(e)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    fwd_ms = stage_device_ms(device_events, ("train_forward",))["train_forward"][1]
    opt_ms = sum(e.time_range.elapsed_us() for e in device_events if e.name.startswith("Optimizer.step")) / 1e3
    flash_ms = {part: sum(e.time_range.elapsed_us() for e in kernels if any(p in e.name for p in patterns)) / 1e3
                for part, patterns in (("forward", VIT_FORWARD_KERNEL),
                                       ("dkv", ("flash_vit_bwd_dkv",)), ("dq", ("flash_vit_bwd_dq",)))}
    record["profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "forward_ms": fwd_ms, "optimizer_ms": opt_ms,
                         "backward_ms": busy_ms - fwd_ms - opt_ms, "flash_ms": flash_ms,
                         "flash_share": sum(flash_ms.values()) / max(busy_ms, 1e-9)}
    print(f"train_mingtok profile (one bf16 step, profiled): wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} "
          f"busy_share={busy_ms / wall_ms:.3f}; device ms: forward {fwd_ms:.1f}, backward "
          f"{busy_ms - fwd_ms - opt_ms:.1f}, AdamW {opt_ms:.1f} (its span); flash kernels "
          f"{sum(flash_ms.values()):.2f} ({', '.join(f'{k} {v:.2f}' for k, v in flash_ms.items())}; share "
          f"{record['profile']['flash_share']:.3f}); device events {len(kernels)}")
    top = [e for e in prof.key_averages() if e.device_type == cuda and not annotation(e)]
    for e in sorted(top, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"train_mingtok profile kernel: {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} calls "
              f"{e.self_device_time_total / max(e.count, 1):10.3f} us/call  {e.key[:90]}")
    return state


def run_train_mingtok(torch, device, results: dict) -> bool:
    """MingTok joint training on one card as `examples/train_mingtok.py` runs it:
    the full `MingTokConfig()` (encoder 12 x 768, semantic decoder 24 x 1024,
    pixel decoder 24 x 1024 on 1,024 tokens of 16 heads x 64), random bf16
    weights from seed 7, B 2 x 512 px from the synthetic image stream (seed 0,
    normalised on the card), random teacher features (2, 256, 1024) at feature
    weight 1.0, AdamW(1e-4, weight decay 1e-4), the same batch every step.
    Rounds, each on the state the last one left: "bf16" (a warm-up step and 3
    timed: the loss must fall), "bf16" with remat (2), "default" (2), "high"
    (2; the JAX package's default tier, no kernel). Per round: ms per step
    (synchronised, median of the steps after the first), images/s, resident and peak
    memory, every loss (finite), the launches per step. Then one profiled bf16
    step."""
    import dataclasses

    import numpy as np

    from mingunivision_tpu_torch.config import MingTokConfig
    from mingunivision_tpu_torch.engine.train import (
        ImageStream,
        TrainState,
        make_mingtok_optimizer,
        make_mingtok_train_step,
        normalize_images_chw,
    )
    from mingunivision_tpu_torch.utils.convert import _Init, init_mingtok_params
    from mingunivision_tpu_torch.utils.pytree import leaves

    t0 = time.perf_counter()
    base = MingTokConfig()
    params = init_mingtok_params(base, _Init(device, torch.bfloat16, torch.Generator(device=device).manual_seed(7)))
    n_params = sum(t.numel() for t in leaves(params))
    state = TrainState.create(params, make_mingtok_optimizer(1e-4))
    B, S = 2, base.encoder.img_size
    images = normalize_images_chw(ImageStream(S, seed=0).batch(B)[0], device)
    g = torch.Generator(device=device).manual_seed(8)
    teacher = torch.randn((B, (S // base.encoder.patch_size) ** 2, base.feature_dim), device=device,
                          generator=g).to(torch.bfloat16)
    torch.cuda.synchronize()
    print(f"train_mingtok: {n_params / 1e9:.3f} B params bf16 (MingTokConfig(), full width and depth) in "
          f"{time.perf_counter() - t0:.1f} s; images {tuple(images.shape)} fp32, teacher {tuple(teacher.shape)}")
    ok, record = True, {}
    # (label, tier, remat, steps): each round's first step warms its tier up (the first "high" step took 3.6x
    # the second in the first run), so ms/step is the median of the others
    for label, tier, remat, steps in (("bf16", "bf16", False, 4), ("bf16_remat", "bf16", True, 2),
                                      ("default", "default", False, 2), ("high", "high", False, 2)):
        cfg = dataclasses.replace(base, pixel_decoder=dataclasses.replace(base.pixel_decoder, matmul_precision=tier))
        step = make_mingtok_train_step(cfg, remat=remat)
        losses, step_ms = [], []

        def steps_run():
            nonlocal state
            for _ in range(steps):  # noqa: B023
                t1 = time.perf_counter()
                state, (loss, metrics) = step(state, images, teacher)  # noqa: B023
                losses.append(float(loss))  # noqa: B023  (reads the loss: the step is synchronised)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)  # noqa: B023

        _, launches, peak = counted_round(torch, results, f"train_mingtok_{label}", steps_run)
        resident = torch.cuda.memory_allocated()
        ms = statistics.median(step_ms[1:])
        checks = [(f"losses {', '.join(f'{v:.4f}' for v in losses)} finite", all(np.isfinite(losses)))]
        if label == "bf16":
            checks.append((f"last {losses[-1]:.4f} < first {losses[0]:.4f}", losses[-1] < losses[0]))
            for name in ("flash_vit_bwd_dkv", "flash_vit_bwd_dq"):
                results.setdefault(name, {})["launches"] = launches[name]
        checks += mingtok_round_checks(launches, tier, steps, remat)
        print(f"train_mingtok [{label}]: B={B} x {S} px ms/step {ms:.1f} (steps {', '.join(f'{v:.1f}' for v in step_ms)}"
              f"; warm-up first) images/s {B / ms * 1e3:.2f}; resident {resident / 2**30:.3f} GiB, "
              f"peak {peak / 2**30:.3f} GiB; launches per step: "
              + ", ".join(f"{n}={launches[n] // steps}" for n in ("flash_vit", "flash_vit_bwd_dkv", "flash_vit_bwd_dq")))
        ok &= report(f"train_mingtok {label}", {n: v for n, v in launches.items() if v}, checks)
        record[label] = {"losses": losses, "step_ms": step_ms, "ms_per_step": ms, "images_per_s": B / ms * 1e3,
                         "resident_gib": resident / 2**30, "peak_gib": peak / 2**30}
    if "launches" not in results.get("flash_vit", {}):  # recon did not run: the train step's forwards, per step
        results.setdefault("flash_vit", {})["launches"] = results["flash_vit"]["launches_by_path"][
            "train_mingtok_bf16"] // 4
    cfg = dataclasses.replace(base, pixel_decoder=dataclasses.replace(base.pixel_decoder, matmul_precision="bf16"))
    step = make_mingtok_train_step(cfg)
    state = profile_mingtok_step(torch, state, lambda st: step(st, images, teacher), record["bf16"])
    results["train_mingtok"] = {"params_b": n_params / 1e9, **record}
    del state, step, params
    gc.collect()
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# the tenth slice: several images per request, the gathered-expert matmul
# ---------------------------------------------------------------------------


def expert_matmul_cases(torch, results, experts, routing, g) -> bool:
    """Row 12 at the pool's decode shapes on the 16B-A3B expert tables (layer
    0 of `experts`): the gathered-expert matmul over the gate table (N = 1408)
    at 12, 18, 36 and 72 assignments (2, 3, 6 and 12 CFG rows x top-6), over
    the down table (N = 2048) at 12, and skewed, 72 assignments on two
    experts; against its plain version within REL_TOL, `torch._grouped_mm`
    over the rows sorted by expert as the library time (the sort not timed).
    Bound: the bytes of each distinct slab once, x and the output. Then the
    whole `moe_experts_gather_kernel` (three launches) at 12 and 36 tokens x
    top-6 against its plain version, and held within REL_TOL of row 1's
    decode-MoE kernel on the same inputs (both bf16 operands with fp32 sums;
    the stream kernel sums the k experts in another order)."""
    from mingunivision_tpu_torch.ops.kernels.expert_matmul import (
        gathered_expert_matmul,
        gathered_expert_matmul_plain,
        moe_experts_gather_kernel,
        moe_experts_gather_plain,
    )
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream

    name = "gathered_expert_matmul"
    bf = torch.bfloat16
    w1, w2 = experts["gate_proj"][0], experts["down_proj"][0]
    E, h, m = w1.shape
    k = 6
    ok = True
    cases = [(f"A={rows * k} ({rows} rows x top-{k}), gate table", rows, w1, None) for rows in (2, 3, 6, 12)]
    cases += [(f"A={2 * k} (2 rows x top-{k}), down table", 2, w2, None),
              (f"A={12 * k} skewed: every assignment on experts 3 and 40, gate table", 12, w1, [3, 40])]
    for label, rows, w, skew in cases:
        if skew is None:
            ids = routing(rows)[0].reshape(-1).to(torch.int32)
        else:  # top-k routing picks k distinct experts: the skewed ids are set directly
            ids = torch.tensor(skew, device="cuda", dtype=torch.int32).repeat(rows * k // len(skew))
        A, (_, K, N) = ids.numel(), w.shape
        x = torch.randn((A, K), device="cuda", generator=g).to(bf)
        distinct = int(torch.unique(ids).numel())
        nbytes = distinct * K * N * 2 + A * K * 2 + A * N * 2
        order = torch.argsort(ids)
        xs, offs = x[order], torch.bincount(ids, minlength=E).cumsum(0).to(torch.int32)
        reads = A * K * N * 2 / 1e6
        ok &= run_case(torch, results, name, f"{label}; {distinct} distinct experts, {reads:.1f} MB read per "
                       "assignment", lambda: gathered_expert_matmul(x, w, ids),  # noqa: B023
                       lambda: gathered_expert_matmul_plain(x, w, ids), nbytes, 2.0 * A * K * N, "bf16",  # noqa: B023
                       library=lambda: torch._grouped_mm(xs, w, offs=offs))  # noqa: B023
    for tokens in (12, 36):
        x = torch.randn((tokens, h), device="cuda", generator=g).to(bf)
        idx, tw = routing(tokens)
        distinct = int(torch.unique(idx).numel())
        nbytes = distinct * 3 * h * m * 2 + 2 * tokens * h * 2
        label = f"moe_experts_gather_kernel: {tokens} tokens x top-{k} ({distinct} distinct experts), 3 launches"
        ok &= run_case(torch, results, name, label,
                       lambda: moe_experts_gather_kernel(experts, x, idx, tw, layer_idx=0),  # noqa: B023
                       lambda: moe_experts_gather_plain(experts, x, idx, tw, layer_idx=0),  # noqa: B023
                       nbytes, 6.0 * tokens * k * h * m, "bf16",
                       others={"moe_stream": lambda: moe_experts_stream(experts, x, idx, tw,  # noqa: B023
                                                                        layer_idx=0)})
        same, err, rel = compare(torch, moe_experts_gather_kernel(experts, x, idx, tw, layer_idx=0),
                                 moe_experts_stream(experts, x, idx, tw, layer_idx=0))
        print(f"kernel {name} [{label}]: against row 1's decode-MoE kernel on the same inputs max_abs_err={err:.3e} "
              f"rel_to_max={rel:.3e} tol_rel={REL_TOL} {'ok' if same else 'MISMATCH'}")
        results[name]["cases"][-1]["vs_moe_stream_max_abs_err"] = err
        ok &= same
    return ok


def pool_requests(cfg, lengths, seed: int = 0):
    """Processor-output dicts of T2I prompts of the given lengths (ids in all),
    built by hand as `t2i_prompt` builds them."""
    out = []
    for i, T in enumerate(lengths):
        ids, am, um, tm = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token, n_text=T - 6, seed=seed + i)
        out.append({"input_ids": ids, "attention_mask": am, "uncond_attention_mask": um,
                    "text_uncond_attention_mask": tm})
    return out


def pool_entries(torch):
    """`llm_entries` with decode attention by the name the pool's LLM step
    (`batch_engine.pooled_forward`) calls it, and the fused RF sampler entry
    (`rf_head.rf_sample_fused`), every row, as `held_against_plain` takes them."""
    from mingunivision_tpu_torch.engine import batch_engine
    from mingunivision_tpu_torch.models import rf_head
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused_plain

    def every_row(i):
        return lambda args: torch.ones(args[i].shape[0], dtype=torch.bool, device=args[i].device)

    return {**llm_entries(torch),
            "decode_attention": (batch_engine, "decode_attention", decode_attention_plain, every_row(0)),
            "rf_sampler": (rf_head, "rf_sample_fused", rf_sample_fused_plain, every_row(2))}


@contextlib.contextmanager
def decode_moe_capture(rows: int):
    """For the block, record the (args, kwargs) of the first decode-MoE call
    (`bailing_moe.moe_experts_stream`, whatever stands there) over `rows` rows;
    yields a dict whose "call" holds them."""
    from mingunivision_tpu_torch.models import bailing_moe as bm

    seen = {}
    entry = bm.moe_experts_stream

    def capture(*args, **kwargs):
        if "call" not in seen and args[1].shape[0] == rows:
            seen["call"] = (args, kwargs)
        return entry(*args, **kwargs)

    bm.moe_experts_stream = capture
    try:
        yield seen
    finally:
        bm.moe_experts_stream = entry


def run_reference_pool(torch, device, tier="int4", results=None) -> bool:
    """The small model's image pool (`ImagePoolEngine`, 3 slots, chunk 2, 16
    image tokens, the noise off): two requests, then a third admitted while
    they are mid-loop, with per-slot text_cfg 1.0 / 3.0 / 9.0 (at int4 through
    the fused int4 sampler, one group per active slot). Every LLM kernel entry
    and the fused sampler held against its plain version on the same inputs
    at every call (within REL_TOL); three finite images in [-1, 1] that
    differ; on the card at int4, the sampler launched once per active slot
    and micro-step. At bf16 (whose expert tables row 12 takes), row 12 held in
    context: one pool step's decode-MoE inputs captured, and
    `moe_experts_gather_kernel` on them within REL_TOL of its plain version
    and of the decode MoE's output."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.engine.image_pool import ImagePoolEngine
    from mingunivision_tpu_torch.ops.kernels import expert_matmul
    from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused

    cfg, params, _ = small_model(torch, device, tier)
    reqs = pool_requests(cfg, (37, 60, 45), seed=11)
    scales = (1.0, 3.0, 9.0)
    slots, n_tok = 3, cfg.image_gen.num_image_tokens
    sampler_launches = rf_sample_fused.launches
    eng = ImagePoolEngine(params, cfg, RuntimeConfig(max_seq_len=512), slots=slots, chunk=2, device=device)
    with held_against_plain(torch, pool_entries(torch)) as errs, decode_moe_capture(3 * slots) as seen:
        done = [eng.add_request(r, i, text_cfg=s) for i, (r, s) in enumerate(zip(reqs[:2], scales))]
        eng.step()
        done.append(eng.add_request(reqs[2], 2, text_cfg=scales[2]))
        eng.run_until_idle()
    sampler_launches = rf_sample_fused.launches - sampler_launches
    imgs = [r.image for r in done]
    checks = [("3 images done", all(r.done for r in done)),
              ("finite, in [-1, 1]", all(np.isfinite(i).all() and i.min() >= -1 and i.max() <= 1 for i in imgs)),
              ("images of different scales differ",
               min(float(np.abs(imgs[a] - imgs[b]).max()) for a, b in ((0, 1), (1, 2), (0, 2))) > 1e-3),
              (f"{eng.micro_steps} micro-steps == {n_tok + 1 + 2}", eng.micro_steps == n_tok + 3)]
    checks += held_checks({k: v for k, v in errs.items() if k != "rf_sampler"})
    if tier == "int4":
        v = errs["rf_sampler"]
        checks.append((f"rf_sampler in context within {max(v, default=1.0):.3e} <= {REL_TOL} of its plain version at "
                       f"all {len(v)} calls", bool(v) and max(v) <= REL_TOL))
        if device.type == "cuda":
            want = slots * (n_tok + 1)
            checks.append((f"sampler launches {sampler_launches} == {want} (one per active slot and micro-step)",
                           sampler_launches == want))
    if tier == "bfloat16":
        from mingunivision_tpu_torch.models import bailing_moe as bm

        args, kwargs = seen["call"]
        layer = kwargs.get("layer_idx")
        before = expert_matmul.gathered_expert_matmul.launches
        got = expert_matmul.moe_experts_gather_kernel(*args[:4], layer_idx=layer)
        launched = expert_matmul.gathered_expert_matmul.launches - before
        for what, want in (("its plain version", expert_matmul.moe_experts_gather_plain(*args[:4], layer_idx=layer)),
                           ("the decode MoE on the same inputs", bm.moe_experts_stream(*args, **kwargs))):
            same, _, rel = compare(torch, got, want)
            checks.append((f"row 12 in context ({args[1].shape[0]} rows x top-{args[2].shape[1]}, layer {layer}) vs "
                           f"{what}: {rel:.3e} <= {REL_TOL}", same))
        if device.type == "cuda":
            checks.append((f"gathered_expert_matmul launches {launched} == 3", launched == 3))
        if results is not None:
            entry = results.setdefault("gathered_expert_matmul", {})
            entry.setdefault("launches_by_path", {})["reference image pool (in context)"] = launched
    print(f"reference ({tier} small model on the card, image pool: 3 slots, chunk 2, a request admitted mid-loop, "
          "text_cfg 1 / 3 / 9): " + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks))
    return all(p for _, p in checks)


def image_round_checks(imgs, n, size=512) -> list:
    """n finite images of (3, size, size) in [-1, 1] that differ pairwise."""
    import numpy as np

    checks = [(f"{n} images", len(imgs) == n)]
    if len(imgs) == n:
        checks += [(f"shape (3, {size}, {size}), finite, in [-1, 1]",
                    all(i.shape == (3, size, size) and np.isfinite(i).all() and i.min() >= -1 and i.max() <= 1
                        for i in imgs)),
                   ("images differ pairwise", min((float(np.abs(imgs[a] - imgs[b]).max())
                                                   for a in range(n) for b in range(a + 1, n)), default=0) > 1e-3)]
    return checks


def run_images(torch, cfg, params, device, results: dict, tier="int4") -> bool:
    """T2I with n_images=2 through the session at full width: the 37-id
    prompt, 2 CFG rows x 2 images = 4 rows in one loop (the decode MoE over 4
    rows, one fused-sampler launch per image token for both images: 4 rows
    fill one launch)."""
    from mingunivision_tpu_torch.config import GenerationConfig, RuntimeConfig
    from mingunivision_tpu_torch.engine.session import MingUniVisionSession

    L, n_tok = cfg.llm.num_hidden_layers, cfg.image_gen.num_image_tokens
    ids, am, um, tm = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, ids, device)
    label = f"images_{tier}"

    def run():
        sess = MingUniVisionSession(params, cfg, RuntimeConfig(), seed=0, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.generate(ids, am, uncond_attention_mask=um, text_uncond_attention_mask=tm,
                            generation=GenerationConfig(max_new_tokens=1), n_images=2)
        torch.cuda.synchronize()
        return out, sess, time.perf_counter() - t0

    (out, sess, total_s), launches, peak = counted_round(torch, results, label, run)
    t = sess.timings
    decode_moe, prefill_moe, sampler = tier_kernels(tier)
    floors = {decode_moe: L * (n_tok + 1), prefill_moe: L, "decode_attention": L * (n_tok + 1), sampler: n_tok}
    checks = image_round_checks(out.images, 2, math.isqrt(n_tok) * 32) + launch_checks(launches, floors)
    checks += [("2 CFG rows x 2 images", (t.get("cfg_rows"), t.get("n_images")) == (2, 2)),
               (f"{sampler} launches == {n_tok} (4 rows: one launch)", launches[sampler] == n_tok)]
    print(f"{label} T2I n_images=2: prompt {ids.shape[1]} ids, {L} layers, {tier}, rows=4, "
          f"prefill_ms={t['prefill_ms']:.2f} image_loop_ms={t['image_loop_ms']:.1f} "
          f"ms_per_ar_token={t['image_loop_ms'] / n_tok:.3f} pixel_decode_ms={t['pixel_decode_ms']:.2f} "
          f"total_s={total_s:.3f} images_per_min={2 * 60 / total_s:.3f} launches_per_llm_step: "
          f"{decode_moe}={launches[decode_moe] / (n_tok + 1):.2f} "
          f"decode_attention={launches['decode_attention'] / (n_tok + 1):.2f} "
          f"{sampler}={launches[sampler] / n_tok:.2f} "
          f"max_memory_allocated_gib={peak / 2**30:.3f}")
    return report(label, launches, checks)


def run_image_batch(torch, cfg, params, device, results: dict, tier="int4") -> bool:
    """The barrier batcher at full width: 3 T2I prompts of 37, 90 and 200 ids
    (one 256-id bucket, a 768-row batched prefill through the capacity
    dispatch), 3 CFG rows each: 9 rows in one loop, one fused-sampler launch
    per image and token (3 rows each)."""
    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.ops.kernels.moe_capacity import moe_experts_capacity_gmm_exact
    from mingunivision_tpu_torch.serving.image_batch import batched_image_generation

    L, n_tok, n = cfg.llm.num_hidden_layers, cfg.image_gen.num_image_tokens, 3
    reqs = pool_requests(cfg, (37, 90, 200), seed=40)
    label = f"image_batch_{tier}"
    fallbacks = moe_experts_capacity_gmm_exact.fallbacks

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = batched_image_generation(params, cfg, RuntimeConfig(), reqs, 0)
        torch.cuda.synchronize()
        return imgs, time.perf_counter() - t0

    (imgs, total_s), launches, peak = counted_round(torch, results, label, run)
    fallbacks = moe_experts_capacity_gmm_exact.fallbacks - fallbacks
    decode_moe, prefill_moe, sampler = tier_kernels(tier)
    floors = {decode_moe: L * (n_tok + 1), prefill_moe: L, "decode_attention": L * (n_tok + 1), sampler: n * n_tok}
    checks = image_round_checks(list(imgs), n)
    checks += launch_checks({k: v for k, v in launches.items() if k != "moe_capacity"}, floors)
    checks += [(f"{sampler} launches == {n * n_tok} (one per image and token)", launches[sampler] == n * n_tok),
               (f"capacity dispatch {launches['moe_capacity']} + fallbacks {fallbacks} == {L}",
                launches["moe_capacity"] + fallbacks == L)]
    print(f"{label}: 3 prompts of 37 / 90 / 200 ids (bucket 256), {L} layers, {tier}, rows=9, total_s={total_s:.3f} "
          f"ms_per_ar_token={total_s * 1e3 / n_tok:.3f} (the round's wall time / {n_tok}, prefill and pixel decode "
          f"included) images_per_min={n * 60 / total_s:.3f} launches_per_llm_step: "
          f"{decode_moe}={launches[decode_moe] / (n_tok + 1):.2f} "
          f"decode_attention={launches['decode_attention'] / (n_tok + 1):.2f} "
          f"{sampler}={launches[sampler] / n_tok:.2f} "
          f"max_memory_allocated_gib={peak / 2**30:.3f}")
    return report(label, launches, checks)


class MicroClock:
    """Wraps an ImagePoolEngine's micro-step: synchronised milliseconds of each
    one, keyed by the number of active slots it ran."""

    def __init__(self, torch, engine):
        self.torch, self.engine, self.micro = torch, engine, engine._micro
        self.ms: dict = {}
        engine._micro = self

    def __call__(self):
        active = sum(self.engine._active)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.micro()
        self.torch.cuda.synchronize()
        if active:
            self.ms.setdefault(active, []).append((time.perf_counter() - t0) * 1e3)


def run_image_pool(torch, cfg, params, device, results: dict, tier="int4") -> bool:
    """Continuous admission at full width: `ImagePoolWorker` over
    `ImagePoolEngine(slots=4, chunk=32)` (max_seq_len 4096); two T2I requests,
    then two more submitted once the pool has run 64 micro-steps, text_cfg
    3.0 / 3.0 / 1.0 / 5.0, seeds 0-3. Per micro-step: one LLM step over the
    12 rows, one fused-sampler launch per active slot, the semantic decoder
    at per-slot positions. ms per micro-step at 2 and 4 active slots (median,
    synchronised), images per minute from the first submit to the last image."""
    import numpy as np

    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.engine.image_pool import ImagePoolEngine
    from mingunivision_tpu_torch.serving.server import ImagePoolWorker

    L, n_tok = cfg.llm.num_hidden_layers, cfg.image_gen.num_image_tokens
    reqs = pool_requests(cfg, (37, 52, 41, 64), seed=50)
    scales = (3.0, 3.0, 1.0, 5.0)
    label = f"image_pool_{tier}"

    def run():
        eng = ImagePoolEngine(params, cfg, RuntimeConfig(), slots=4, chunk=32, device=device)
        clock = MicroClock(torch, eng)
        worker = ImagePoolWorker(eng)
        try:
            t0 = time.perf_counter()
            items = [worker.submit(reqs[i], i, {"text_cfg": scales[i]}) for i in (0, 1)]
            while eng.micro_steps < 64 and not all(i["event"].is_set() for i in items):
                time.sleep(0.01)
            items += [worker.submit(reqs[i], i, {"text_cfg": scales[i]}) for i in (2, 3)]
            finished = [item["event"].wait(600) for item in items]
            wall = time.perf_counter() - t0
        finally:
            worker.stop()
        errors = [item.get("error") for item in items if item.get("error")]
        imgs = [item["req"].image for item in items if item.get("req") is not None and item["req"].done]
        return eng, clock, imgs, all(finished) and not errors, errors, wall

    (eng, clock, imgs, served, errors, wall), launches, peak = counted_round(torch, results, label, run)
    steps = eng.micro_steps
    decode_moe, prefill_moe, sampler = tier_kernels(tier)
    floors = {decode_moe: L * steps, prefill_moe: 4 * L, "decode_attention": L * steps, sampler: 4 * (n_tok + 1)}
    checks = [(f"4 requests served{'' if served else f' ({errors})'}", served)] + image_round_checks(imgs, 4)
    checks += launch_checks(launches, floors)
    checks += [(f"{sampler} launches == {4 * (n_tok + 1)} (one per active slot and micro-step)",
                launches[sampler] == 4 * (n_tok + 1)),
               (f"{decode_moe} launches == {L} x {steps} micro-steps", launches[decode_moe] == L * steps),
               (f"micro-steps {steps}: the late pair's {n_tok + 1} after its admission at a chunk boundary >= 64",
                steps - (n_tok + 1) >= 64 and (steps - (n_tok + 1)) % 32 == 0)]
    st = eng.state
    kv_bytes = 2 * st.k.numel() * st.k.element_size()
    sem_bytes = 2 * st.sem_k.numel() * st.sem_k.element_size()
    ms = {a: statistics.median(v) for a, v in sorted(clock.ms.items())}
    print(f"{label}: 4 slots x 3 CFG rows, chunk 32, {L} layers, {tier}, prompts 37 / 52 / 41 / 64 ids, text_cfg "
          f"{' / '.join(map(str, scales))}, {steps} micro-steps, wall_s={wall:.3f} images_per_min={4 * 60 / wall:.3f} "
          + " ".join(f"ms_per_micro_step_at_{a}_active={v:.3f} (n={len(clock.ms[a])})" for a, v in ms.items())
          + f" launches_per_micro_step: {decode_moe}={launches[decode_moe] / steps:.2f} "
          f"decode_attention={launches['decode_attention'] / steps:.2f} {sampler}={launches[sampler] / steps:.3f} "
          f"pool_kv_bytes={kv_bytes} ({kv_bytes / 2**30:.3f} GiB; semantic-decoder cache {sem_bytes}) "
          f"max_memory_allocated_gib={peak / 2**30:.3f}")
    del eng
    return report(label, launches, checks)


def kernel_entry(name: str, r: dict, capacity: dict) -> dict:
    """One kernel's entry of the JSON line, from what this run measured:
    `launches` from the main path that runs it (its tier's T2I slice; the
    understanding round for flash prefill; one reconstruction batch for flash
    ViT; the per-step reference round for the two stack bodies no full-width
    round runs; null when that path did not run, and for the pipelined sampler
    and the full-block prefill, which no entry point reaches) and
    `launches_by_path` from every
    path driven, whether it is on a second design (`REDESIGNED`), the worst
    `max_abs_err` over the kernels phase's cases, and
    `ms`, `plain_ms`, `library_ms`, `bound_ms`, `bound_by` at that path's own
    shape (the first case); then every case."""
    source, replaces = KERNELS[name]
    cases = r.get("cases", [])
    first = cases[0] if cases else {}
    return {"name": name, "route": "cuda", "source": f"mingunivision_tpu_torch/{source}", "replaces": replaces,
            "redesigned": name in REDESIGNED, "launches": r.get("launches"),
            "max_abs_err": max((c["max_abs_err"] for c in cases), default=None),
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
    ap.add_argument("--phases", default="device,build,kernels,reference,train,train_mingtok,slice,slice_int4,"
                                        "slice_int4_exact,images_int4,image_batch_int4,image_pool_int4,"
                                        "slice_int4_perstep,slice_int4_rf8,slice_int8,slice_int8_s8,slice_int8_perstep,"
                                        "slice_nf4,understand,edit,recon,serve")
    ap.add_argument("--tier", default="bfloat16", choices=("bfloat16", "int4", "int8", "nf4"),
                    help="the tier of the profile, profile_understand, routing and divergence phases")
    ap.add_argument("--rf-per-step", action="store_true",
                    help="the profile phase's RF head through the per-step stack (rf_fused_sampler=False)")
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

    from mingunivision_tpu_torch.config import MingUniVisionConfig, RuntimeConfig

    cuda = torch.device("cuda")
    results: dict = {}
    ok = True
    t_script = time.perf_counter()

    def stamp(phase):
        print(f"clock: {phase} done at {time.perf_counter() - t_script:.1f} s")

    if "kernels" in phases:
        ok &= check_kernels(torch, results)
        ok &= check_train_kernels(torch, results)
        ok &= check_flash_vit_train_kernels(torch, results)
        stamp("kernels")
    if "reference" in phases:
        for tier, runtime_kw in REFERENCE_TIERS:
            ok &= run_reference(torch, cuda, tier, **runtime_kw)
            ok &= run_reference_image(torch, cuda, tier, **runtime_kw)
        for tier, runtime_kw in PER_STEP_REFERENCE_TIERS:
            ok &= run_reference(torch, cuda, tier, results, **runtime_kw)
        ok &= run_reference_serve(torch, cuda)
        ok &= run_reference_pool(torch, cuda, "bfloat16", results)
        ok &= run_reference_pool(torch, cuda, "int4", results)
        ok &= run_reference_train(torch, cuda)
        ok &= run_reference_mingtok(torch, cuda, "bf16")
        ok &= run_reference_mingtok(torch, cuda, "default", remat=True)
        stamp("reference")
    if "train" in phases:
        ok &= run_train(torch, cuda, results)
        stamp("train")
    if "train_mingtok" in phases:
        ok &= run_train_mingtok(torch, cuda, results)
        stamp("train_mingtok")
    if "divergence" in phases:
        ok &= run_divergence(torch, cuda, args.tier)
    if "rf_sensitivity" in phases:
        ok &= run_rf_sensitivity(torch)
    if "recon" in phases:
        ok &= run_recon(torch, MingUniVisionConfig(), cuda, results)
        stamp("recon")
    # per tier: (its T2I phase, the other phases it runs); the int4 tier's model also serves the mixed tier
    tier_phases = {"bfloat16": ("slice", {"understand", "edit", "serve"}),
                   "int4": ("slice_int4", {"slice_int4_exact", "slice_int4_perstep", "slice_int4_rf8", "images_int4",
                                           "image_batch_int4", "image_pool_int4", "understand", "edit", "serve"}),
                   "int8": ("slice_int8", {"slice_int8_s8", "slice_int8_perstep", "understand", "edit"}),
                   "nf4": ("slice_nf4", set())}
    for tier, (slice_phase, others) in tier_phases.items():
        run = phases & (others | {slice_phase})
        if not run:
            continue
        cfg = MingUniVisionConfig()
        if tier == "nf4":  # its plain-dequant loop is the slowest per token: cut to NF4_IMAGE_TOKENS
            cfg = dataclasses.replace(cfg, image_gen=dataclasses.replace(cfg.image_gen,
                                                                         num_image_tokens=NF4_IMAGE_TOKENS))
        mixed = "slice_int4_rf8" in run
        params = full_model(torch, cfg, cuda, tier, keep_rf_bf16=mixed)  # built once for the tier's phases
        if slice_phase in run:
            ok &= run_slice(torch, cfg, params, cuda, results, tier)
        short = dataclasses.replace(cfg, image_gen=dataclasses.replace(cfg.image_gen,
                                                                       num_image_tokens=VARIANT_IMAGE_TOKENS))
        if "slice_int4_exact" in run:  # the exact-dequant int4 decode kernel
            ok &= run_slice(torch, short, params, cuda, results, tier, RuntimeConfig(moe_int_dots=False),
                            "slice_int4_exact")
        if "slice_int8_s8" in run:  # the int8 sampler with s8 dots
            ok &= run_slice(torch, short, params, cuda, results, tier, RuntimeConfig(rf_int_dots=True),
                            "slice_int8_s8")
        if f"slice_{tier}_perstep" in run:  # the per-step RF route: the stack kernel in the tier's default body
            ok &= run_slice(torch, short, params, cuda, results, tier, RuntimeConfig(rf_fused_sampler=False),
                            f"slice_{tier}_perstep")
        if mixed:
            ok &= run_slice_mixed(torch, short, params, cuda, results)
        # several images per request: n_images=2, the barrier batcher, the image pool
        for phase, round_fn in (("images", run_images), ("image_batch", run_image_batch),
                                ("image_pool", run_image_pool)):
            if f"{phase}_{tier}" in run:
                ok &= round_fn(torch, short if phase == "images" else cfg, params, cuda, results, tier)
                torch.cuda.empty_cache()
        if "edit" in run:
            ok &= run_edit(torch, cfg, params, cuda, results, tier)
        if "understand" in run:  # it steers the LM head towards text
            ok &= run_understand(torch, cfg, params, cuda, results, tier)
            if tier != "bfloat16":  # and again with the s8 prefill kernel
                ok &= run_understand(torch, cfg, params, cuda, results, tier, prefill_int_dots=True, prepare=False)
            if tier == "int8":  # and in the exact-dequant decode mode
                ok &= run_understand(torch, cfg, params, cuda, results, tier, int_dots=False, prepare=False)
        if "serve" in run:
            ok &= run_serve(torch, cfg, params, cuda, results, tier, steered="understand" in phases)
        del params
        gc.collect()  # a tier's tree is held by reference cycles of the serving phase (engine <-> step clock)
        torch.cuda.empty_cache()
        stamp(f"the {tier} tier's rounds")
    if "decode_kernels" in phases:
        ok &= run_decode_kernels(torch, results)
    if "prefill_kernels" in phases:
        ok &= run_prefill_kernels(torch, results)
    if "sampler_kernels" in phases:
        ok &= run_sampler_kernels(torch, results)
    if "stack_kernels" in phases:
        ok &= run_stack_kernels(torch, results)
    if "routing" in phases:
        ok &= run_routing(torch, MingUniVisionConfig(), cuda, args.tier)
    if "profile" in phases:
        ok &= run_profile(torch, MingUniVisionConfig(), cuda, args.tier, per_step=args.rf_per_step)
    if "serve_check" in phases:
        ok &= run_serve_check(torch, cuda)
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
