#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mingunivision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure exits non-zero:
  1. device   card name and power limit (nvidia-smi); TF32 off
  2. build    nvcc-builds the kernels under mingunivision_tpu_torch/csrc
  3. kernels  each CUDA kernel against its plain PyTorch version, in bf16, at
              the main path's shapes: max abs error, error relative to
              max |plain|, and median CUDA-event times of both
  4. reference  a small model on the card through the kernels (bf16) against
              the plain versions in fp32: same tokens, image error within
              twice the plain bf16 path's own
  5. slice    single-image text-to-image through MingUniVisionSession.generate
              at the full 16B-A3B width (random weights from a seed, bf16,
              max_seq_len 4096): output checks, launch counts of every kernel,
              prefill / image-loop / pixel-decode times, peak memory
Then a JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--phases` picks the phases (default: the five above). Two more run only when
named:
  divergence  the small model's plain bf16 path with each kernel swapped in
              alone, and all three, against plain bf16 and fp32: semantic-token
              error at loop step 0 and over the loop, image error
  profile     the slice with a 16-token image loop under torch.profiler:
              device ms per stage, device busy share, device events per token,
              top kernels; then the same round unprofiled
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
# the TPU kernel each CUDA kernel replaces (file:line of the Pallas kernel body)
REPLACES = {
    "moe_stream": "mingunivision_tpu/ops/kernels/moe_stream.py:51",
    "moe_swiglu_gmm": "mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py:70",
    "decode_attention": "mingunivision_tpu/ops/kernels/decode_attention.py:38",
}
SOURCES = {name: f"mingunivision_tpu_torch/csrc/{name}.cu" for name in REPLACES}
REL_TOL = 1e-2  # bf16 kernel vs plain: max |err| <= REL_TOL * max |plain| (bf16 keeps ~3 digits)


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


def check_kernels(torch, results: dict) -> bool:
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream, moe_experts_stream_plain
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import (
        moe_experts_swiglu_gmm,
        moe_experts_swiglu_gmm_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    E, h, m, k = 64, 2048, 1408, 6  # MingUniVisionConfig().llm
    experts = {
        "gate_proj": torch.empty((1, E, h, m), device=dev, dtype=bf).normal_(0, 0.02, generator=g),
        "up_proj": torch.empty((1, E, h, m), device=dev, dtype=bf).normal_(0, 0.02, generator=g),
        "down_proj": torch.empty((1, E, m, h), device=dev, dtype=bf).normal_(0, 0.02, generator=g),
    }

    def routing(n, choices=None):
        scores = torch.rand((n, E), device=dev, generator=g)
        if choices is not None:  # skewed: only these experts are ever routed
            allowed = torch.zeros(E, dtype=torch.bool, device=dev)
            allowed[choices] = True
            scores = scores.masked_fill(~allowed, -1.0)
        w, idx = torch.topk(torch.softmax(scores, -1), k)
        return idx, (w / w.sum(-1, keepdim=True)).to(bf)

    all_ok = True
    cases = [
        ("moe_stream", "N=2 k=6 (slice decode)", 2, None),
        ("moe_stream", "N=16 k=6 (A>E dedup)", 16, None),
        ("moe_swiglu_gmm", "128 tok x k=6 (slice prefill)", 128, None),
        ("moe_swiglu_gmm", "128 tok x k=6 skewed to 8 experts", 128, [0, 5, 9, 17, 33, 34, 50, 63]),
    ]
    for name, label, n, choices in cases:
        x = torch.randn((n, h), device=dev, generator=g).to(bf)
        idx, w = routing(n, choices)
        if name == "moe_stream":
            kern = lambda: moe_experts_stream(experts, x, idx, w, layer_idx=0)  # noqa: E731
            plain = lambda: moe_experts_stream_plain(experts, x, idx, w, layer_idx=0)  # noqa: E731
        else:
            kern = lambda: moe_experts_swiglu_gmm(experts, x, idx, w, E, layer_idx=0)  # noqa: E731
            plain = lambda: moe_experts_swiglu_gmm_plain(experts, x, idx, w, E, layer_idx=0)  # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        ok, err, rel = compare(torch, got, want)
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        print(f"kernel {name} [{label}]: max_abs_err={err:.3e} rel_to_max={rel:.3e} tol_rel={REL_TOL} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} {'ok' if ok else 'MISMATCH'}")
        all_ok &= ok
        results.setdefault(name, {}).setdefault("cases", []).append(
            {"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    B, Hq, Hkv, S, D = 2, 16, 4, 4096, 128  # 2 CFG rows over the default 4096 cache
    q = torch.randn((B, 1, Hq, D), device=dev, generator=g).to(bf)
    kc = torch.randn((B, Hkv, S, D), device=dev, generator=g).to(bf)
    vc = torch.randn((B, Hkv, S, D), device=dev, generator=g).to(bf)
    mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
    mask[0, :700] = True
    mask[1, :321] = True
    mask[1, 400:450] = True  # CFG-style hole
    mask[1, 3000:3001] = True  # an isolated allowed position in a late tile
    kern = lambda: decode_attention(q, kc, vc, mask)  # noqa: E731
    plain = lambda: decode_attention_plain(q, kc, vc, mask)  # noqa: E731
    got = kern()
    torch.cuda.synchronize()
    ok, err, rel = compare(torch, got, plain())
    ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
    print(f"kernel decode_attention [B=2 S=4096 CFG holes]: max_abs_err={err:.3e} rel_to_max={rel:.3e} "
          f"tol_rel={REL_TOL} ms={ms:.4f} plain_ms={plain_ms:.4f} {'ok' if ok else 'MISMATCH'}")
    all_ok &= ok
    results.setdefault("decode_attention", {})["cases"] = [
        {"shape": "B=2 S=4096 CFG holes", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}]
    del experts
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

    from mingunivision_tpu_torch.engine.session import build_cfg_masks

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
    the prompt, as the engine tests do. The column is set to +-10: a probe
    prefill of the prompt picks the sign that makes its logit large and positive."""
    from mingunivision_tpu_torch.engine.generate import prefill
    from mingunivision_tpu_torch.models.bailing_moe import LLMCache, embed_tokens

    img = cfg.llm.image_start_token
    T = ids.shape[1]
    col = params["llm"]["lm_head"]["w"][:, img]
    col.fill_(10.0)
    cache = LLMCache.create(cfg.llm, 1, 128, col.dtype, device)
    mask = torch.zeros((1, 128), dtype=torch.bool, device=device)
    mask[:, :T] = True
    ids_pad = torch.zeros((1, 128), dtype=torch.long, device=device)
    ids_pad[:, :T] = torch.as_tensor(ids, device=device)
    logits, _ = prefill(params["llm"], cfg.llm, embed_tokens(params["llm"], ids_pad), cache, mask)
    if float(logits[0, img]) < 0:
        col.fill_(-10.0)


def randomize_adaln(params, generator):
    """Draw the RF head's zero-initialised AdaLN and final layers at std 0.02, so
    the sampled latents, and so the image, depend on the LLM's hidden states."""
    rf = params["rf_head"]
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.02, generator=generator)


def _generate(torch, params, cfg, runtime, device, prompt, image_gen=None):
    """One T2I round through the port's session; returns (output, session, seconds)."""
    from mingunivision_tpu_torch.engine.session import GenerationConfig, MingUniVisionSession

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


@contextlib.contextmanager
def plain_versions(names=tuple(REPLACES)):
    """Route the main path's calls of the named kernels to their plain versions
    for the block (the names the model module calls them by are patched)."""
    from mingunivision_tpu_torch.models import bailing_moe as bm
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_plain
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_plain

    swaps = {"moe_stream": ("moe_experts_stream", moe_experts_stream_plain),
             "moe_swiglu_gmm": ("moe_experts_swiglu_gmm", moe_experts_swiglu_gmm_plain),
             "decode_attention": ("decode_attention", decode_attention_plain)}
    saved = {attr: getattr(bm, attr) for attr, _ in swaps.values()}
    for name in names:
        setattr(bm, *swaps[name])
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(bm, attr, fn)


def small_model(torch, device):
    """A 2-layer model with the full model's structure, bf16 on the card, RF
    noise off (temperature 0), 16 image tokens; returns (cfg, params, prompt)."""
    import dataclasses

    from mingunivision_tpu_torch.engine.session import ImageGenConfig, MingUniVisionConfig
    from mingunivision_tpu_torch.utils.convert import init_mm_params

    base = MingUniVisionConfig()
    llm = dataclasses.replace(base.llm, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=64, moe_intermediate_size=128, num_experts=8,
                              num_experts_per_tok=2)
    rf = dataclasses.replace(base.rf_head, target_channels=8, z_channels=64, width=64, depth=2)
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
    prompt = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, prompt[0], device)
    return cfg, params, prompt


def run_reference(torch, device) -> bool:
    """The small model three ways: through the kernels (bf16), through their
    plain versions (bf16) and through the plain versions in fp32, the
    reference. The kernel path must give the reference's tokens, and its image
    may differ from the reference's by at most twice what bf16 alone costs the
    plain path, plus 1e-2. (bf16 rounding grows through the 16-token loop to
    about the same error whether or not the kernels run: `--phases divergence`
    shows where the paths part.)"""
    import numpy as np

    from mingunivision_tpu_torch.engine.session import RuntimeConfig
    from mingunivision_tpu_torch.utils.pytree import tree_map

    cfg, params, prompt = small_model(torch, device)
    params_f32 = tree_map(lambda t: t.float(), params)
    out_k, sess_k, _ = _generate(torch, params, cfg, RuntimeConfig(max_seq_len=512), device, prompt, cfg.image_gen)
    with plain_versions():
        out_p, _, _ = _generate(torch, params, cfg, RuntimeConfig(max_seq_len=512), device, prompt, cfg.image_gen)
        out_r, _, _ = _generate(torch, params_f32, cfg, RuntimeConfig(max_seq_len=512, compute_dtype="float32"),
                                device, prompt, cfg.image_gen)
    checks = image_checks(out_k, sess_k, cfg, prompt[0].shape[1], cfg.mingtok.encoder.img_size)
    ok_images = all(len(o.images) == 1 for o in (out_k, out_p, out_r))
    err_k = float(np.abs(out_k.images[0] - out_r.images[0]).max()) if ok_images else float("inf")
    err_p = float(np.abs(out_p.images[0] - out_r.images[0]).max()) if ok_images else float("inf")
    tol = 2 * err_p + 1e-2
    checks += [("tokens == fp32 reference", out_k.token_ids == out_r.token_ids),
               (f"image err vs fp32 {err_k:.3e} <= {tol:.3e} (plain bf16 err {err_p:.3e})", err_k <= tol)]
    print("reference (small model on the card: kernels bf16 vs plain fp32): "
          + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks))
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

    from mingunivision_tpu_torch.engine import generate as gen_mod
    from mingunivision_tpu_torch.engine import session as session_mod
    from mingunivision_tpu_torch.engine.session import RuntimeConfig
    from mingunivision_tpu_torch.utils.pytree import tree_map

    cfg, params, prompt = small_model(torch, device)
    hiddens, sems = [], []
    loop, vis_head = session_mod.generate_image_tokens, gen_mod.vis_head_apply

    def capture_loop(*args, **kwargs):
        res = loop(*args, **kwargs)
        sems.append(res.sem_tokens[0].float().cpu().numpy())
        return res

    def capture_hidden(p, x):
        hiddens.append(x.float().cpu().numpy())
        return vis_head(p, x)

    def run(params, plain, compute_dtype="bfloat16"):
        hiddens.clear()
        with plain_versions(plain):
            out, _, _ = _generate(torch, params, cfg, RuntimeConfig(max_seq_len=512, compute_dtype=compute_dtype),
                                  device, prompt, cfg.image_gen)
        return np.stack(hiddens), sems[-1], out.images[0]

    session_mod.generate_image_tokens, gen_mod.vis_head_apply = capture_loop, capture_hidden
    try:
        ref = run(tree_map(lambda t: t.float(), params), tuple(REPLACES), "float32")
        base = run(params, tuple(REPLACES))
        variants = {"plain bf16": base, "all kernels": run(params, ())}
        for name in REPLACES:
            variants[f"only {name}"] = run(params, tuple(n for n in REPLACES if n != name))
    finally:
        session_mod.generate_image_tokens, gen_mod.vis_head_apply = loop, vis_head
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


def full_model(torch, cfg, device):
    """Random bf16 weights of `cfg` on the device from seed 0, and the prompt;
    returns (params, prompt)."""
    from mingunivision_tpu_torch.utils.convert import init_mm_params
    from mingunivision_tpu_torch.utils.pytree import leaves

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_mm_params(cfg, device=device, dtype=torch.bfloat16, generator=gen)
    randomize_adaln(params, gen)
    prompt = t2i_prompt(cfg.llm.vocab_size, cfg.llm.image_start_token)
    bias_to_image_start(torch, params, cfg, prompt[0], device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"init: {n_params / 1e9:.3f} B params bf16 on device in {time.perf_counter() - t0:.1f} s "
          f"(allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    return params, prompt


def run_slice(torch, cfg, device, results: dict) -> bool:
    from mingunivision_tpu_torch.engine.session import RuntimeConfig
    from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm

    L = cfg.llm.num_hidden_layers
    params, prompt = full_model(torch, cfg, device)
    kernels = {"moe_stream": moe_experts_stream, "moe_swiglu_gmm": moe_experts_swiglu_gmm,
               "decode_attention": decode_attention}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out, sess, total_s = _generate(torch, params, cfg, RuntimeConfig(), device, prompt)
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    T = prompt[0].shape[1]
    n_tok = cfg.image_gen.num_image_tokens
    floors = {"moe_stream": L * (n_tok + 1), "moe_swiglu_gmm": L, "decode_attention": L * (n_tok + 1)}
    checks = image_checks(out, sess, cfg, T, 512)
    checks += [(f"{name} launches {launches[name]} >= {floor}", launches[name] >= floor) for name, floor in floors.items()]
    t = sess.timings
    print(f"slice T2I: prompt {T} ids (bucket 128), {L} layers, cfg_rows={t.get('cfg_rows')}, "
          f"prefill_ms={t['prefill_ms']:.2f} image_loop_ms={t['image_loop_ms']:.1f} "
          f"ms_per_ar_token={t['image_loop_ms'] / n_tok:.3f} pixel_decode_ms={t['pixel_decode_ms']:.2f} "
          f"total_s={total_s:.3f} max_memory_allocated_gib={peak / 2**30:.3f}")
    print("slice checks: " + "; ".join(f"{label}={'ok' if p else 'FAILED'}" for label, p in checks))
    for name, n in launches.items():
        results.setdefault(name, {})["launches"] = n
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


def run_profile(torch, cfg, device, n_tok: int = 16) -> bool:
    """Where the slice's time goes: one round at full width with an n_tok-token
    image loop under torch.profiler, each stage in a profiler range. Prints the
    device (kernel) ms of each stage (llm_forward includes the prefill's
    forward; llm_decode_step is the rest per step; ranges nest, so the stages
    do not sum to the busy time), the device busy time against
    the wall clock, device events per image token, and the top kernels; then
    the same round unprofiled, for its wall clock."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile, record_function

    from mingunivision_tpu_torch.engine import generate, session
    from mingunivision_tpu_torch.engine.session import RuntimeConfig

    params, prompt = full_model(torch, cfg, device)
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
    print(f"profile (slice, {n_tok} image tokens, profiled): wall_s={wall_s:.3f} device_busy_ms={busy_ms:.1f} "
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
    `launches` from the slice phase (null when it did not run), the worst
    `max_abs_err` over the kernels phase's cases, `ms` / `plain_ms` at the
    slice's own shape (the first case), and every case."""
    cases = r.get("cases", [])
    return {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": r.get("launches"),
            "max_abs_err": max((c["max_abs_err"] for c in cases), default=None),
            "ms": cases[0]["ms"] if cases else None, "plain_ms": cases[0]["plain_ms"] if cases else None,
            "cases": cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,build,kernels,reference,slice")
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
          f"(nvcc {build.build_info['seconds']:.2f} s, cached={build.build_info['cached']})")

    results: dict = {}
    ok = True
    if "kernels" in phases:
        ok &= check_kernels(torch, results)
    if "reference" in phases:
        ok &= run_reference(torch, torch.device("cuda"))
    if "divergence" in phases:
        ok &= run_divergence(torch, torch.device("cuda"))
    from mingunivision_tpu_torch.engine.session import MingUniVisionConfig

    if "slice" in phases:
        ok &= run_slice(torch, MingUniVisionConfig(), torch.device("cuda"), results)
    if "profile" in phases:
        ok &= run_profile(torch, MingUniVisionConfig(), torch.device("cuda"))
    if "jax" in sys.modules:
        return fail("jax was imported")
    if not ok:
        return fail("a phase failed (see above)")
    print(json.dumps({"kernels": [kernel_entry(name, r) for name, r in results.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
