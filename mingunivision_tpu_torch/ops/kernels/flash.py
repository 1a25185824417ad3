"""Flash attention for first-round prefill and for the ViT decoders: the CUDA
kernel `csrc/flash_attention.cu`, its two wrappers, their plain versions and
the static gates; and for training, the ViT entry's forward with residuals,
its two backward kernels (dK / dV and dQ, with their plain versions) and the
autograd Function over them.

Replaces mingunivision_tpu/ops/kernels/flash.py (`flash_prefill_attention`
and `flash_vit_attention`, both over the Pallas flash-attention kernel that
ships with JAX, and under autodiff that kernel's custom VJP: the forward with
residuals and the backward kernels `_flash_attention_bwd_dkv` and
`_flash_attention_bwd_dq`). The function is softmax(Q K^T * scale) V over a full
sequence whose fresh keys are the whole context, with the (rows, keys) scores
kept out of device memory. On the H100 it is bound by its operations (4 * D
per allowed query-key pair; q, k, v and the output each move once), so the
kernel keeps both products on the tensor cores (bf16, fp32 accumulators)
and the online-softmax state in registers; see the source note: the prefill
and the ViT forward are two modes of one wgmma body over a TMA-fed ring (the
prefill reading q, k and v token-major where they lie, its query tiles
visiting the key tiles up to the diagonal only), the ViT backward's two
kernels wgmma bodies of their own (N a multiple of 128, as the forward's
gate requires, so every shape an entry point hands the backward fits its
tile too).

The gates follow the JAX package's TPU dispatch on every device (the port's
CPU path is the plain version of the same function, not another path).

Each wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from mingunivision_tpu_torch.ops.attention import mha
from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.linear import current_fp32_precision

_KERNEL_HEAD_DIMS = (64, 128)
PREFILL_TILE = 128  # the prefill's query and key tile (the forward's wgmma body)
VIT_TILE = 128  # the ViT kernels' (wgmma: forward, dK / dV, dQ) tile of a block's resident rows


def flash_usable(T: int) -> bool:
    """Static gate of the prefill kernel: tile-friendly lengths from 512 up."""
    return T >= 512 and T % 128 == 0


def flash_vit_usable(N: int, dtype) -> bool:
    """Gate of the ViT kernel: tile-aligned N from 512 up, and a numerics tier
    the kernel's bf16 products cannot degrade: bf16 inputs always qualify,
    fp32 inputs only inside `fp32_matmul_precision("default")` (at "high" /
    "highest" it would break those tiers' fp32 guarantee)."""
    if not (N >= 512 and N % 128 == 0):
        return False
    if dtype == torch.bfloat16:
        return True
    return dtype == torch.float32 and current_fp32_precision() == "default"


def _prefill_mask(valid_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) bool -> (B, 1, T, T): key j <= row i and valid[i] == valid[j]."""
    T = valid_mask.shape[1]
    pos = torch.arange(T, device=valid_mask.device)
    causal = pos[None, :] <= pos[:, None]
    same = valid_mask[:, :, None] == valid_mask[:, None, :]
    return (causal[None] & same)[:, None]


def flash_prefill_attention_plain(q, k, v, valid_mask, *, scale: float):
    """Plain PyTorch of `flash_prefill_attention`: fp32 scores, the same mask
    rule, probabilities rounded to v's type, output rounded to q's type."""
    return mha(q, k, v, scale=scale, mask=_prefill_mask(valid_mask.bool()))


def flash_prefill_attention(q, k, v, valid_mask, *, scale: float):
    """q (B, T, Hq, D); k/v (B, T, Hkv, D); valid_mask bool (B, T) -> (B, T, Hq, D).

    Row i attends to key j iff j <= i and valid[i] == valid[j]: causal within
    the valid prefix of a right-padded prompt. Padding rows are DEFINED by the
    same rule (they attend to the padding keys at or before them, as the
    segment ids of the TPU kernel make them); callers ignore them.
    """
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, valid_mask, scale=scale)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_prefill_attention: needs bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or valid_mask.shape != (B, T):
        raise ValueError(f"flash_prefill_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"valid {tuple(valid_mask.shape)}")
    if D not in _KERNEL_HEAD_DIMS or T % PREFILL_TILE or Hq % Hkv:
        raise ValueError(f"flash_prefill_attention: needs head_dim in {_KERNEL_HEAD_DIMS}, T a multiple of "
                         f"{PREFILL_TILE} and Hq a multiple of Hkv (D={D}, T={T}, Hq={Hq}, Hkv={Hkv})")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    valid = _aligned(valid_mask.to(torch.bool))
    out = torch.empty_like(q)
    rc = build.load().mu_flash_prefill_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
                                            B, T, Hq, Hkv, D, float(scale), build.stream_handle(q))
    build.check(rc, "mu_flash_prefill_bf16")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0


def flash_vit_attention_plain(q, k, v, *, scale: float):
    """Plain PyTorch of `flash_vit_attention`, head-major in and out; fp32
    inputs go through bf16 as in the kernel's wrapper."""
    dt = q.dtype
    if dt == torch.float32:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)
    return out.transpose(1, 2).to(dt)


def _scores(q, k, scale: float):
    """fp32 S * scale of head-major q (B, H, N, D) and k (B, H, S, D)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_vit_attention_lse_plain(q, k, v, *, scale: float):
    """Plain version of the forward with residuals: (out, lse), out as
    `flash_vit_attention_plain` (bf16 q, k, v) and lse (B, H, N) fp32 the
    log-sum-exp of each row's scaled scores."""
    return flash_vit_attention_plain(q, k, v, scale=scale), torch.logsumexp(_scores(q, k, scale), dim=-1)


def _probs(q, k, lse, scale: float):
    return torch.exp(_scores(q, k, scale) - lse[..., None])


def flash_vit_bwd_dkv_plain(q, k, v, lse, do, delta, *, scale: float):
    """Plain version of the dK / dV kernel: fp32 math from the library's
    formula (`mha_reference_bwd`), P = exp(S * scale - lse), dV = P^T dO,
    dS = P * (dO V^T - delta) * scale, dK = dS^T Q; (dK, dV) in k's dtype."""
    p = _probs(q, k, lse, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None]) * scale
    return torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype), dv.to(v.dtype)


def flash_vit_bwd_dq_plain(q, k, v, lse, do, delta, *, scale: float):
    """Plain version of the dQ kernel: dQ = dS K in fp32, in q's dtype."""
    p = _probs(q, k, lse, scale)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None]) * scale
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_vit_delta(o, do):
    """delta = rowsum(O * dO) in fp32, (B, H, N): the backward's per-row term,
    computed outside the kernels as the library computes it in XLA. One fp32
    copy of o takes the product in place (do is widened on the fly): the same
    values as o.float() * do.float(), one fp32 tensor fewer written and read."""
    return o.to(torch.float32, copy=True).mul_(do).sum(-1)


def flash_vit_attention_bwd_plain(q, k, v, o, lse, do, *, scale: float):
    """The whole backward in plain PyTorch: (dQ, dK, dV) from the forward's
    inputs, output and log-sum-exp and the output's cotangent."""
    delta = flash_vit_delta(o, do)
    dk, dv = flash_vit_bwd_dkv_plain(q, k, v, lse, do, delta, scale=scale)
    return flash_vit_bwd_dq_plain(q, k, v, lse, do, delta, scale=scale), dk, dv


def _check_vit(name, *tensors):
    """The ViT kernels' contract: bf16 head-major (B, H, N, D) of one shape, D
    in _KERNEL_HEAD_DIMS, N a multiple of VIT_TILE."""
    shape = tensors[0].shape
    for t in tensors:
        if t.dtype is not torch.bfloat16:
            raise ValueError(f"{name}: needs bf16 q/k/v, got {[t.dtype for t in tensors]}")
        if t.shape != shape:
            raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}")
    D, N = shape[3], shape[2]
    if D not in _KERNEL_HEAD_DIMS or N % VIT_TILE:
        raise ValueError(f"{name}: needs head_dim in {_KERNEL_HEAD_DIMS} and N a multiple of {VIT_TILE} (D={D}, N={N})")
    return shape


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (a copy where it is not): TMA reads 16-byte rows."""
    if not t.is_contiguous():
        return t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _vit_forward(q, k, v, scale: float, with_lse: bool):
    """Launch the ViT forward on bf16 CUDA tensors: out, and lse when asked."""
    B, H, N, D = _check_vit("flash_vit_attention", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if with_lse else None
    rc = build.load().mu_flash_vit_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        lse.data_ptr() if with_lse else None, B, H, N, D, float(scale),
                                        build.stream_handle(q))
    build.check(rc, "mu_flash_vit_bf16")
    flash_vit_attention.launches += 1
    return out, lse


def flash_vit_attention_lse(q, k, v, *, scale: float):
    """The forward with residuals, bf16 head-major q, k, v: (out bf16, lse fp32
    (B, H, N)). Its launches count on `flash_vit_attention` (one kernel, two modes)."""
    if q.device.type == "cpu":
        return flash_vit_attention_lse_plain(q, k, v, scale=scale)
    return _vit_forward(q, k, v, scale, True)


def flash_vit_bwd_dkv(q, k, v, lse, do, delta, *, scale: float):
    """dK, dV (bf16) of the ViT attention from the forward's inputs, its
    log-sum-exp, the output's cotangent dO (bf16) and delta (fp32)."""
    if q.device.type == "cpu":
        return flash_vit_bwd_dkv_plain(q, k, v, lse, do, delta, scale=scale)
    B, H, N, D = _check_vit("flash_vit_bwd_dkv", q, k, v, do)
    q, k, v, do, lse, delta = (_aligned(t) for t in (q, k, v, do, lse.float(), delta.float()))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = build.load().mu_flash_vit_bwd_dkv_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                                                do.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
                                                N, D, float(scale), build.stream_handle(q))
    build.check(rc, "mu_flash_vit_bwd_dkv_bf16")
    flash_vit_bwd_dkv.launches += 1
    return dk, dv


def flash_vit_bwd_dq(q, k, v, lse, do, delta, *, scale: float):
    """dQ (bf16) of the ViT attention; the inputs as `flash_vit_bwd_dkv`."""
    if q.device.type == "cpu":
        return flash_vit_bwd_dq_plain(q, k, v, lse, do, delta, scale=scale)
    B, H, N, D = _check_vit("flash_vit_bwd_dq", q, k, v, do)
    q, k, v, do, lse, delta = (_aligned(t) for t in (q, k, v, do, lse.float(), delta.float()))
    dq = torch.empty_like(q)
    rc = build.load().mu_flash_vit_bwd_dq_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                                               do.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, N, D,
                                               float(scale), build.stream_handle(q))
    build.check(rc, "mu_flash_vit_bwd_dq_bf16")
    flash_vit_bwd_dq.launches += 1
    return dq


class FlashViTAttention(torch.autograd.Function):
    """The ViT flash attention with the library's custom VJP
    (flash_attention.py `_flash_attention_fwd` / `_flash_attention_bwd`): the
    forward saves q, k, v, the output and its log-sum-exp; the backward forms
    delta, then runs the dK / dV kernel and the dQ kernel. bf16 in and out.
    On the card q, k and v are made contiguous and aligned once here (the
    pixel decoder hands in strided views of its qkv), so neither kernel of
    the backward copies them again. The three entries are looked up in this
    module at each call."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type != "cpu":
            q, k, v = _aligned(q), _aligned(k), _aligned(v)
        out, lse = flash_vit_attention_lse(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = flash_vit_delta(out, do)
        dk, dv = flash_vit_bwd_dkv(q, k, v, lse, do, delta, scale=ctx.scale)
        dq = flash_vit_bwd_dq(q, k, v, lse, do, delta, scale=ctx.scale)
        return dq, dk, dv, None


def flash_vit_attention(q, k, v, *, scale: float):
    """Non-causal full-sequence ViT attention, HEAD-MAJOR (B, H, N, D) in and
    out. fp32 inputs (the "default" tier, see `flash_vit_usable`) are cast to
    bf16 for the kernel, whose products are bf16 either way, and the output is
    cast back. When a gradient is wanted, through `FlashViTAttention` (the
    forward with residuals, then the backward kernels); its grads come back
    in bf16 and through the casts in fp32, as JAX's casts give them."""
    dt = q.dtype
    if dt == torch.float32:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashViTAttention.apply(q, k, v, scale).to(dt)
    if q.device.type == "cpu":
        return flash_vit_attention_plain(q, k, v, scale=scale).to(dt)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_vit_attention: needs bf16 or fp32 q/k/v, got {dt}/{k.dtype}/{v.dtype}")
    out = _vit_forward(q, k, v, scale, False)[0]
    return out if dt is torch.bfloat16 else out.to(dt)


flash_vit_attention.launches = 0
flash_vit_bwd_dkv.launches = 0
flash_vit_bwd_dq.launches = 0
