"""Weight-only int8/int4 quantization (counterpart of mingunivision_tpu/utils/quantize.py),
with the identical byte formats, so a table quantized by either package runs
in the other:

  - int8: symmetric per-output-channel, q = clip(round(w / s), -127, 127),
    s = max(|w| over the contraction axis / 127, 1e-8), fp32 scales;
  - int4 "linear": the same with 7 in place of 127, stored offset-binary
    (nibble = q + 8) and packed two nibbles per byte "split-halves" along the
    contraction axis: the low nibble plane is contraction rows [0, n/2), the
    high plane rows [n/2, n); `groups` > 1 packs each of `groups` contiguous
    contraction blocks on its own;
  - int4 "nf4": the nibble indexes the NormalFloat4 codebook, s = per-channel
    absmax. The port reads NF4 tables through `dequant_weight` only (the
    JAX package has no kernel for them either).

The contraction axis is the second-to-last in every layout the models use:
(in, out), (E, in, out) and depth-stacked (L, E, in, out).
"""

from __future__ import annotations

import torch

from mingunivision_tpu_torch.ops.kernels.intdot import div_exact

# The 16 NormalFloat4 code values (quantiles of N(0,1) normalised to [-1, 1]).
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

_QUANT_MIN_SIZE = 1 << 16  # smaller tensors (norms, biases, gates) stay floating point
_SLICE_BYTES = 256 * 1024 * 1024  # quantize_tree_inplace works on larger leaves one leading slice at a time


class QuantizedArray:
    """A quantized weight: `q` (int8, or uint8 packed int4) and fp32 scales `s`
    with the contraction axis reduced to 1; `bits`, `groups`, `scheme` as in
    the JAX package. Indexing takes the same leading index of `q` and `s`
    (a zero-copy view), which is how a layer of a depth-stacked table is read."""

    __slots__ = ("q", "s", "bits", "groups", "scheme")

    def __init__(self, q, s, bits: int = 8, groups: int = 1, scheme: str = "linear"):
        self.q = q
        self.s = s
        self.bits = int(bits)
        self.groups = int(groups)
        self.scheme = str(scheme)

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.q.device

    def __getitem__(self, idx):
        return QuantizedArray(self.q[idx], self.s[idx], self.bits, self.groups, self.scheme)

    def to(self, device):
        return QuantizedArray(self.q.to(device), self.s.to(device), self.bits, self.groups, self.scheme)

    def __repr__(self):
        return f"QuantizedArray(shape={tuple(self.q.shape)}, bits={self.bits}, groups={self.groups}, scheme={self.scheme})"


def is_int4_linear(w) -> bool:
    """True for a single-group linear-scheme int4 table: what the int4 kernels take."""
    return isinstance(w, QuantizedArray) and w.bits == 4 and w.scheme == "linear" and w.groups == 1


def is_int8_linear(w) -> bool:
    """True for an int8 table (int8 `q` (..., in, out), fp32 `s` (..., 1, out)):
    what the int8 kernels take."""
    return (isinstance(w, QuantizedArray) and w.bits == 8 and w.scheme == "linear" and w.groups == 1
            and w.q.dtype == torch.int8 and w.s.dtype == torch.float32 and w.s.shape[-2] == 1
            and w.s.shape[-1] == w.q.shape[-1])


def is_nf4(w) -> bool:
    """True for an NF4 table (the "int4-nf4" tier): read by plain dequant on every device."""
    return isinstance(w, QuantizedArray) and w.bits == 4 and w.scheme == "nf4"


def quantize_array(w: torch.Tensor, bits: int = 8, groups: int = 1, scheme: str = "linear") -> QuantizedArray:
    """Per-channel quantization; int4 packs two nibbles per byte split-halves
    along the contraction axis (see the module docstring). Runs on w's device,
    with the same bytes on every device."""
    w = w.float()
    ax = w.ndim - 2
    amax = w.abs().amax(dim=ax, keepdim=True)
    if scheme == "nf4":
        if bits != 4:
            raise ValueError("nf4 is a 4-bit scheme")
        s = amax.clamp_min(1e-8)
        code = torch.tensor(NF4_CODE, dtype=torch.float32, device=w.device)
        mid = (code[1:] + code[:-1]) / 2.0
        qo = torch.searchsorted(mid, (w / s).contiguous()).to(torch.uint8)
    else:
        qmax = 127.0 if bits == 8 else 7.0
        s = div_exact(amax, qmax).clamp_min(1e-8)
        q = torch.round(w / s).clamp_(-qmax, qmax).to(torch.int8)
        if bits != 4:
            return QuantizedArray(q, s, bits)
        qo = (q + 8).to(torch.uint8)
    n = w.shape[ax]
    if n % (2 * groups):
        raise ValueError(f"int4 packing needs the contraction dim {n} divisible by {2 * groups}")
    blk = n // groups
    packed = [qo.narrow(ax, g * blk, blk // 2) | (qo.narrow(ax, g * blk + blk // 2, blk // 2) << 4)
              for g in range(groups)]
    q = torch.cat(packed, dim=ax) if groups > 1 else packed[0].contiguous()
    return QuantizedArray(q, s, bits, groups, scheme)


def dequant_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight in `dtype`: dequantizes a QuantizedArray (in fp32, then cast) or casts a tensor."""
    if not isinstance(w, QuantizedArray):
        return w.to(dtype)
    if w.bits != 4:
        return (w.q.float() * w.s).to(dtype)
    ax = w.q.ndim - 2
    nf4 = w.scheme == "nf4"
    lo = (w.q & 0xF).int() if nf4 else (w.q & 0xF).to(torch.int8) - 8  # NF4: codebook indexes
    hi = (w.q >> 4).int() if nf4 else (w.q >> 4).to(torch.int8) - 8
    if w.groups == 1:
        q = torch.cat([lo, hi], dim=ax)
    else:  # per-group split-halves: the G lo/hi block pairs in turn
        nb = w.q.shape[ax] // w.groups
        q = torch.cat([p for g in range(w.groups) for p in (lo.narrow(ax, g * nb, nb), hi.narrow(ax, g * nb, nb))],
                      dim=ax)
    if nf4:
        vals = torch.tensor(NF4_CODE, dtype=torch.float32, device=w.q.device)[q]
        return (vals * w.s).to(dtype)
    return (q.float() * w.s).to(dtype)


def take_weight(w, idx: torch.Tensor, axis: int = 0):
    """Gather along `axis` of a quantized or plain table; a size-1 (broadcast)
    scale axis is left as it is."""
    if isinstance(w, QuantizedArray):
        s = w.s if w.s.shape[axis] == 1 else w.s.index_select(axis, idx)
        return QuantizedArray(w.q.index_select(axis, idx), s, w.bits, w.groups, w.scheme)
    return w.index_select(axis, idx)


def _policy_bits(parts, x, bits: int, min_size: int):
    """The JAX package's leaf policy: the bits a leaf at key path `parts` is
    quantized to, or None when it stays as it is."""
    if not isinstance(x, torch.Tensor) or x.ndim < 2 or not x.is_floating_point() or x.numel() < min_size:
        return None
    pstr = ".".join(parts)
    is_weight = parts[-1] == "w" or parts[-1] in ("gate_proj", "up_proj", "down_proj")
    parent = parts[-2] if len(parts) >= 2 else ""
    is_norm = "norm" in parent or parent.endswith("ln") or parent.startswith("ln")
    if not is_weight or is_norm:
        return None
    if "gate.w" in pstr or "image_gate" in pstr or "audio_gate" in pstr:
        return None  # routers stay full precision
    if bits == 4 and ("word_embeddings" in pstr or x.shape[-2] % 2):
        return 8  # embedding rows are gathered before dequant; odd contraction dims cannot pack
    return bits


def _quantize_leaf(parts, x, bits, min_size, scheme):
    b = _policy_bits(parts, x, bits, min_size)
    if b is None:
        return x
    return quantize_array(x, b, scheme=scheme if b == 4 else "linear")


def _walk(tree, parts, visit):
    if isinstance(tree, dict):
        return {k: _walk(v, parts + [str(k)], visit) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, parts + [str(i)], visit) for i, v in enumerate(tree))
    return visit(parts, tree)


def quantize_tree(params, bits: int = 8, min_size: int = _QUANT_MIN_SIZE, scheme: str = "linear"):
    """Quantize every large >= 2-D floating weight of a param tree (dict
    leaves named "w" and the expert tables); routers, norms, biases and small
    tensors stay floating point. At 4 bits the word embeddings and tables with
    an odd contraction dim become int8. Returns a new tree."""
    return _walk(params, [], lambda parts, x: _quantize_leaf(parts, x, bits, min_size, scheme))


def quantize_tree_inplace(params: dict, bits: int = 8, min_size: int = _QUANT_MIN_SIZE,
                          scheme: str = "linear") -> dict:
    """`quantize_tree` that replaces the leaves of `params` one at a time, so
    each floating leaf can be freed before the next is quantized; leaves over
    256 MB are quantized one leading (depth) slice at a time into preallocated
    tables, which bounds the fp32 temporaries by one slice. Scales reduce over
    the contraction axis only, so slicing the leading axis changes no value.
    Mutates and returns `params`."""

    def walk(d, parts):
        keys = range(len(d)) if isinstance(d, list) else list(d.keys())
        for k in keys:
            v = d[k]
            path = parts + [str(k)]
            if isinstance(v, (dict, list)):
                walk(v, path)
                continue
            b = _policy_bits(path, v, bits, min_size)
            if b is None:
                continue
            if v.numel() * v.element_size() > _SLICE_BYTES and v.ndim >= 3 and v.shape[0] > 1:
                first = _quantize_leaf(path, v[:1], bits, min_size, scheme)
                q = first.q.new_empty((v.shape[0],) + tuple(first.q.shape[1:]))
                s = first.s.new_empty((v.shape[0],) + tuple(first.s.shape[1:]))
                q[:1], s[:1] = first.q, first.s
                for i in range(1, v.shape[0]):
                    piece = _quantize_leaf(path, v[i : i + 1], bits, min_size, scheme)
                    q[i : i + 1], s[i : i + 1] = piece.q, piece.s
                d[k] = QuantizedArray(q, s, first.bits, first.groups, first.scheme)
            else:
                d[k] = _quantize_leaf(path, v, bits, min_size, scheme)
            del v

    walk(params, [])
    return params
