"""Training checkpoints (the training part of the counterpart of
mingunivision_tpu/utils/checkpoint.py): a param tree, or a train state's
params and AdamW moments, saved as one torch file and restored into a
template tree in place; `AsyncTrainCheckpointer` copies the state to host
memory and writes it on a background thread while training goes on. The
JAX package writes Orbax directories; the port writes `torch.save` files.
(The reference checkpoint loaders, safetensors and `.bin`, are not here.)
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from mingunivision_tpu_torch.utils.pytree import leaves, tree_map


def _host_copy(tree):
    """The tree with every tensor copied to host memory: the card's tensors
    into pinned buffers without blocking, then one synchronise."""
    on_card = []

    def copy(t):
        if isinstance(t, torch.Tensor):
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            out.copy_(t.detach(), non_blocking=t.is_cuda)
            on_card.append(t.is_cuda)
            return out
        return t

    out = tree_map(copy, tree)
    if any(on_card):
        torch.cuda.synchronize()
    return out


def _state_tree(state):
    """A param tree as it is, or a TrainState's {"params", "opt" (step count and
    AdamW moments in leaf order), "step"}."""
    if not hasattr(state, "opt_state"):
        return state
    opt = state.opt_state
    moments = []
    for p in opt.leaves:
        st = opt.opt.state.get(p, {})
        moments.append({k: st[k] for k in ("exp_avg", "exp_avg_sq", "step") if k in st})
    return {"params": state.params, "opt": {"count": opt.count, "moments": moments}, "step": state.step}


def save_pytree(path: str, tree) -> None:
    """Write a param tree (or a TrainState) to `path` as one torch file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_host_copy(_state_tree(tree)), tmp)
    os.replace(tmp, path)


def _copy_into(dst, src) -> None:
    for a, b in zip(leaves(dst), leaves(src), strict=True):
        if a.shape != b.shape:
            raise ValueError(f"checkpoint leaf of shape {tuple(b.shape)} for a template leaf of {tuple(a.shape)}")
        with torch.no_grad():
            a.copy_(b)


def restore_pytree(path: str, template=None):
    """Read a file of `save_pytree`. Without a template: the tree on the host.
    With a param tree or a TrainState as template: its tensors are overwritten
    in place (params, and a state's AdamW moments, count and step) and it is
    returned."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if template is None:
        return saved
    if not hasattr(template, "opt_state"):
        _copy_into(template, saved)
        return template
    _copy_into(template.params, saved["params"])
    opt = template.opt_state
    for p, st in zip(opt.leaves, saved["opt"]["moments"], strict=True):
        if st:
            opt.opt.state[p] = {k: v.to(p.device) if k != "step" else v.clone() for k, v in st.items()}
        else:
            opt.opt.state.pop(p, None)
    opt.count = int(saved["opt"]["count"])
    template.step = int(saved["step"])
    return template


class AsyncTrainCheckpointer:
    """Training checkpoints that do not stop the loop: `save(path, state)`
    copies the params (and a TrainState's AdamW state) to host memory, then
    writes them on a background thread and returns; a new save waits for the
    previous write. `wait()` joins the write in flight, `restore(path,
    template)` waits and restores into the template, `close()` waits."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state) -> None:
        self.wait()
        snapshot = _host_copy(_state_tree(state))

        def write():
            try:
                os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
                tmp = f"{path}.tmp"
                torch.save(snapshot, tmp)
                os.replace(tmp, path)
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="train-checkpoint", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, path: str, template):
        self.wait()
        return restore_pytree(path, template)

    def close(self) -> None:
        self.wait()
