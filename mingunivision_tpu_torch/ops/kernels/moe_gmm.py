"""Grouped matrix products of MoE training and the differentiable grouped-matmul MoE.

Replaces the library Pallas kernels the JAX package reaches through
mingunivision_tpu/ops/kernels/moe_gmm.py (`moe_experts_gmm` -> megablox
`gmm`, and in megablox's custom VJP, ops.py `_gmm_bwd`, `gmm` with the rhs
transposed and `tgmm`): `gmm` (CUDA kernel `csrc/gmm.cu`, `mu_gmm`; the
transposed launches count on `gmm_trhs`) and `tgmm` (`mu_tgmm`), each with
its plain version (one fp32 `torch.matmul` per group, then rounded).
`GroupedMatmul` is `gmm` as a `torch.autograd.Function` whose backward is the
megablox VJP: grad_lhs = gmm(grad, rhs, transpose_rhs=not t) in the lhs dtype,
grad_rhs = tgmm(lhs, grad) in the rhs dtype. `moe_experts_gmm` is the JAX
package's composition over it, step by step (a stable argsort of the
assignments, rows padded to a multiple of 128 into the last group, g and u
in fp32, a = silu(g) * u rounded to x's dtype, y in fp32, a gather-unsort and
an fp32 gate-weighted sum), so autograd differentiates the same function
`jax.vjp` does. It is the backward of the fused prefill MoE in training
(`moe_swiglu_gmm.moe_experts_swiglu_gmm_ad`).

Rows are grouped by `group_sizes` (E,): group e holds the rows after the
first e groups. Rows past sum(group_sizes) belong to no group: gmm leaves them
zero, tgmm reads none of them. On the card the kernels read the (E, K, N) bf16
tables as they lie (a layer's view of the depth-stacked leaf, no copy) and
schedule their row tiles on the device (`gmm_schedule`: no host sync);
`moe_experts_gmm` builds one schedule per layer for its six `gmm` calls.
`gmm` and `tgmm` each have two kernel bodies in `csrc/gmm.cu`, chosen by
shape and alignment alone (`gmm_route`, `tgmm_route`): "wgmma", a TMA-fed
ring of stages into wgmma products (tgmm's in persistent blocks), where TMA
can describe the operands (every shape of the model), and "mma_sync" for the
rest; each route counts its launches in `route_counts`.
The wrappers run the plain versions for CPU tensors only; for CUDA tensors
they launch their kernel or raise. The JAX package's
`expert_sort` (a counting sort its benchmark measured slower than argsort)
has no counterpart: no entry point calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.moe_stream import layer_tables
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import tile_schedule

PAD_ROWS = 128  # moe_experts_gmm pads the sorted rows to a multiple of this (megablox's row tile)
TILE_ROWS = 128  # rows per schedule tile of both gmm routes (csrc/gmm.cu's BM, `mu_gmm_tile_rows`)
GMM_ROUTES = ("wgmma", "mma_sync")
TGMM_MAX_GROUPS = 1024  # groups the wgmma tgmm orders by size in shared memory
_OUT_DTYPES = (torch.float32, torch.bfloat16)


class RouteCount:
    """The launches of one kernel route (the kernel's own `launches` counts every route)."""

    def __init__(self):
        self.launches = 0


route_counts = {op: {route: RouteCount() for route in GMM_ROUTES} for op in ("gmm", "gmm_trhs", "tgmm")}


def _group_bounds(group_sizes: torch.Tensor, rows: int):
    """[(group, first row, end row)] of the non-empty groups, on the host."""
    ends = group_sizes.long().cumsum(0).clamp(max=rows).tolist()
    bounds, start = [], 0
    for e, end in enumerate(ends):
        if end > start:
            bounds.append((e, start, end))
        start = max(start, end)
    return bounds


def gmm_plain(lhs, rhs, group_sizes, *, out_dtype=torch.float32, transpose_rhs: bool = False, sched=None):
    """Plain version of `gmm`: out[rows of e] = lhs[rows of e] @ rhs[e] (rhs[e]^T
    with `transpose_rhs`), one fp32 matmul per group, rounded to `out_dtype`;
    rows of no group are zeros. `sched`, the kernels' tiles, is not needed."""
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((lhs.shape[0], N), dtype=out_dtype, device=lhs.device)
    for e, r0, r1 in _group_bounds(group_sizes, lhs.shape[0]):
        w = rhs[e].float()
        out[r0:r1] = (lhs[r0:r1].float() @ (w.t() if transpose_rhs else w)).to(out_dtype)
    return out


def tgmm_plain(lhs, grad, group_sizes, *, out_dtype=torch.bfloat16):
    """Plain version of `tgmm`: out[e] = lhs[rows of e]^T @ grad[rows of e], one
    fp32 matmul per group, rounded to `out_dtype`; an empty group gets zeros."""
    E = group_sizes.shape[0]
    out = torch.zeros((E, lhs.shape[1], grad.shape[1]), dtype=out_dtype, device=lhs.device)
    for e, r0, r1 in _group_bounds(group_sizes, lhs.shape[0]):
        out[e] = (lhs[r0:r1].float().t() @ grad[r0:r1].float()).to(out_dtype)
    return out


def gmm_schedule(group_sizes: torch.Tensor, rows: int) -> torch.Tensor:
    """The gmm kernels' schedule over `rows` group-sorted rows, on the device (no
    host sync): (n_tiles, 3) int32 rows of (group, first row, end row), the
    groups' tiles of at most TILE_ROWS rows from each group's first row
    (`tile_schedule`), then tiles of group -1 over the rows past the groups'
    sum, which the kernels fill with zeros; unused entries are empty."""
    sizes = group_sizes.long()
    E = sizes.shape[0]
    rest = (rows - sizes.sum()).clamp(min=0).reshape(1)  # the rows of no group, as one more group
    sched = tile_schedule(torch.cat([sizes, rest]), rows, TILE_ROWS)
    sched[:, 0] = torch.where(sched[:, 0] == E, -1, sched[:, 0])
    return sched


def gmm_route(lhs: torch.Tensor, rhs: torch.Tensor, K: int, N: int) -> str:
    """The kernel body `gmm` launches, by shape and alignment alone: "wgmma"
    (TMA copies, which need 16-byte aligned operands and rows: K and N
    multiples of 8 elements), else "mma_sync"."""
    tma = K % 8 == 0 and N % 8 == 0 and lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0
    return "wgmma" if tma else "mma_sync"


def tgmm_route(lhs: torch.Tensor, grad: torch.Tensor, K: int, N: int, E: int) -> str:
    """The kernel body `tgmm` launches, by shape and alignment alone: "wgmma"
    (TMA copies: 16-byte aligned operands, K and N multiples of 8; at least one
    row, at most TGMM_MAX_GROUPS groups), else "mma_sync"."""
    tma = K % 8 == 0 and N % 8 == 0 and lhs.data_ptr() % 16 == 0 and grad.data_ptr() % 16 == 0
    return "wgmma" if tma and lhs.shape[0] > 0 and 0 < E <= TGMM_MAX_GROUPS else "mma_sync"


def _check(op: str, dev, group_sizes, out_dtype, **tensors):
    for name, (t, dtypes, ndim) in tensors.items():
        if t.device != dev or t.dtype not in dtypes or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous {ndim}-d tensor of {dtypes} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{op}: out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    if group_sizes.device != dev or group_sizes.dim() != 1:
        raise ValueError(f"{op}: group_sizes must be a 1-d tensor on {dev}")


def gmm(lhs, rhs, group_sizes, *, out_dtype=torch.float32, transpose_rhs: bool = False, sched=None):
    """out (R, N) = each row of lhs (R, K) times its group's matrix: rhs (E, K, N),
    or rhs (E, N, K) transposed with `transpose_rhs`. On the card: bf16 tables,
    bf16 or fp32 lhs, fp32 or bf16 out, the body `gmm_route` picks; the launch
    counts on `gmm`, or on `gmm_trhs` when transposed, and on its route.
    `sched`: `gmm_schedule(group_sizes, R)`, built here when not given. CPU
    tensors take `gmm_plain`."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes, out_dtype=out_dtype, transpose_rhs=transpose_rhs)
    op = "gmm_trhs" if transpose_rhs else "gmm"
    _check(op, lhs.device, group_sizes, out_dtype, lhs=(lhs, _OUT_DTYPES, 2), rhs=(rhs, (torch.bfloat16,), 3))
    R, K = lhs.shape
    E, K_rhs, N = (rhs.shape[0], rhs.shape[2], rhs.shape[1]) if transpose_rhs else rhs.shape
    if K_rhs != K or group_sizes.shape[0] != E:
        raise ValueError(f"{op}: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} and {group_sizes.shape[0]} groups "
                         f"do not agree")
    return _launch_gmm(lhs, rhs, group_sizes, out_dtype, transpose_rhs, sched, gmm_route(lhs, rhs, K, N))


def _launch_gmm(lhs, rhs, group_sizes, out_dtype, transpose_rhs, sched, route):
    """`gmm`'s launch on `route` and its counts, on checked operands
    (chip_smoke.py also times the mma_sync body at shapes the wgmma one takes)."""
    R, K = lhs.shape
    E, N = rhs.shape[0], rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.empty((R, N), dtype=out_dtype, device=lhs.device)  # the kernels write every row
    if R == 0:
        return out
    if sched is None:
        sched = gmm_schedule(group_sizes, R)
    rc = build.load().mu_gmm(lhs.data_ptr(), rhs.data_ptr(), sched.data_ptr(), out.data_ptr(), sched.shape[0], R, E,
                             K, N, int(lhs.dtype == torch.float32), int(transpose_rhs),
                             int(out_dtype == torch.float32), int(route == "wgmma"), build.stream_handle(lhs))
    build.check(rc, f"mu_gmm ({route})")
    (gmm_trhs if transpose_rhs else gmm).launches += 1
    route_counts["gmm_trhs" if transpose_rhs else "gmm"][route].launches += 1
    return out


def gmm_trhs(lhs, rhs, group_sizes, *, out_dtype=torch.bfloat16, sched=None):
    """`gmm` with the rhs transposed (the VJP's grad_lhs; the name that carries
    those launches' count)."""
    return gmm(lhs, rhs, group_sizes, out_dtype=out_dtype, transpose_rhs=True, sched=sched)


def tgmm(lhs, grad, group_sizes, *, out_dtype=torch.bfloat16):
    """out (E, K, N): per group e, lhs[rows of e]^T @ grad[rows of e], fp32
    accumulation rounded once; zeros for an empty group (megablox's
    `num_actual_groups` visit). On the card: bf16 lhs, bf16 or fp32 grad,
    bf16 or fp32 out, the body `tgmm_route` picks; the launch counts on `tgmm`
    and on its route. CPU tensors take `tgmm_plain`."""
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, grad, group_sizes, out_dtype=out_dtype)
    _check("tgmm", lhs.device, group_sizes, out_dtype, lhs=(lhs, (torch.bfloat16,), 2), grad=(grad, _OUT_DTYPES, 2))
    (R, K), N, E = lhs.shape, grad.shape[1], group_sizes.shape[0]
    if grad.shape[0] != R:
        raise ValueError(f"tgmm: lhs {tuple(lhs.shape)} and grad {tuple(grad.shape)} need the same rows")
    return _launch_tgmm(lhs, grad, group_sizes, out_dtype, tgmm_route(lhs, grad, K, N, E))


def _launch_tgmm(lhs, grad, group_sizes, out_dtype, route, max_blocks: int = 0):
    """`tgmm`'s launch on `route` and its counts, on checked operands
    (chip_smoke.py also times the mma_sync body at shapes the wgmma one takes,
    and the wgmma body on a grid of `max_blocks` blocks: 0 is one per
    multiprocessor)."""
    (R, K), N, E = lhs.shape, grad.shape[1], group_sizes.shape[0]
    sizes = group_sizes.to(torch.int32).contiguous()  # the kernels sum the groups' bounds themselves
    out = torch.empty((E, K, N), dtype=out_dtype, device=lhs.device)  # the kernels write every group
    rc = build.load().mu_tgmm(lhs.data_ptr(), grad.data_ptr(), sizes.data_ptr(), out.data_ptr(), R, E, K, N,
                              int(grad.dtype == torch.float32), int(out_dtype == torch.float32),
                              int(route == "wgmma"), max_blocks, build.stream_handle(lhs))
    build.check(rc, f"mu_tgmm ({route})")
    tgmm.launches += 1
    route_counts["tgmm"][route].launches += 1
    return out


class GroupedMatmul(torch.autograd.Function):
    """`gmm` with megablox's VJP (ops.py `_gmm_bwd`): grad_lhs = gmm(grad, rhs,
    transpose_rhs=not t) in the lhs dtype, grad_rhs = tgmm(lhs, grad) in the
    rhs dtype (transposed back when t). `gmm` and `tgmm` are looked up in this
    module at each call. `sched` (`gmm_schedule` of the group sizes and rows, or
    None) serves the forward and the grad_lhs launch: the same rows, the same
    tiles."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, out_dtype, transpose_rhs, sched=None):
        ctx.save_for_backward(lhs, rhs, group_sizes, sched)
        ctx.transpose_rhs = transpose_rhs
        return gmm(lhs, rhs, group_sizes, out_dtype=out_dtype, transpose_rhs=transpose_rhs, sched=sched)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes, sched = ctx.saved_tensors
        grad = grad.contiguous()
        grad_lhs = grad_rhs = None
        if ctx.needs_input_grad[0]:
            grad_lhs = gmm(grad, rhs, group_sizes, out_dtype=lhs.dtype, transpose_rhs=not ctx.transpose_rhs,
                           sched=sched)
        if ctx.needs_input_grad[1]:
            grad_rhs = tgmm(lhs, grad, group_sizes, out_dtype=rhs.dtype)
            if ctx.transpose_rhs:
                grad_rhs = grad_rhs.transpose(1, 2)
        return grad_lhs, grad_rhs, None, None, None, None


def moe_experts_gmm(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """Exact top-k MoE through three differentiable grouped matmuls (the JAX
    package's `moe_experts_gmm`). experts: (E, h, m)/(E, m, h) floating tables,
    or depth-stacked ones with `layer_idx`; x_flat (N, h); topk_idx (N, k);
    topk_w (N, k). Returns (N, h) in x's dtype."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    N, k = topk_idx.shape
    A = N * k
    A_pad = -(-A // PAD_ROWS) * PAD_ROWS
    flat = topk_idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    xs = x_flat[order // k]  # (A, h) expert-sorted
    sizes = torch.zeros(num_experts, dtype=torch.int64, device=flat.device).index_add_(0, flat, torch.ones_like(flat))
    if A_pad != A:  # pad rows into the LAST group; their outputs are dropped at the combine
        xs = torch.cat([xs, xs.new_zeros((A_pad - A, xs.shape[1]))])
        sizes[-1] += A_pad - A
    sizes = sizes.to(torch.int32)
    sched = gmm_schedule(sizes, A_pad)  # one schedule for the layer's six gmm launches
    dt = xs.dtype
    g = GroupedMatmul.apply(xs, w1.to(dt), sizes, torch.float32, False, sched)
    u = GroupedMatmul.apply(xs, w3.to(dt), sizes, torch.float32, False, sched)
    a = (F.silu(g.float()) * u.float()).to(dt)
    y = GroupedMatmul.apply(a, w2.to(dt), sizes, torch.float32, False, sched)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(A, device=order.device)
    y_orig = y[:A][inv].reshape(N, k, -1).float()
    return (y_orig * topk_w.float()[..., None]).sum(dim=1).to(x_flat.dtype)


gmm.launches = 0
gmm_trhs.launches = 0
tgmm.launches = 0
