"""One frame step captured in one CUDA graph.

The JAX package compiles a frame into one XLA program (``jax.jit`` of
``render_frame``, ``Graph.compile``); the port's counterpart records the
frame's launches, the hand kernels' included, into one CUDA graph
(``torch.cuda.graph``) and replays it. :class:`CapturedStep` does that
for any ``step(state, inputs) -> (new_state, outputs)`` over NamedTuples,
tuples, lists and dicts of tensors (renderer.compile_frame,
graph.Graph.compile):

- it warms up on a clone of the state, on a side stream, so that the
  kernels are built, the tables the frame caches are made and the
  caching allocator has settled, and the caller's state does not advance;
- it captures one step into static buffers: the state (a clone of the
  caller's) and the inputs. The captured graph ends by copying the new
  state into the static state: the state is carried in place, one copy
  of it besides the graph's pool, and the copy costs one pass over it;
- each call copies its inputs into the static inputs (a Python number
  into a tensor by a fill, no host copy) and replays. The state and the
  outputs it returns are the static buffers, which the next call
  overwrites.

Only tensors take new values on a replay: a Python value that the step
reads is frozen at the capture. So the capture checks that the step
returns its state's structure, shapes and non-tensor values unchanged,
and each call checks its inputs' non-tensor values against the
capture's; either raises. A capture that fails raises: there is no
eager fallback.
"""
from __future__ import annotations

import gc
import time

import torch

# eager frames run on a clone of the state before the capture
WARMUP_STEPS = 2


def tree_map(fn, x):
    """``fn`` applied to every tensor in NamedTuples, tuples, lists and
    dicts; any other value is kept as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[tree_map(fn, v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def tree_leaves(x) -> list:
    """The tensors of ``x`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, x)
    return out


def skeleton(x):
    """``x`` with each tensor replaced by its (shape, dtype, device): equal
    skeletons have the same structure, shapes and non-tensor values."""
    return tree_map(lambda t: (tuple(t.shape), t.dtype, t.device), x)


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def assign(static, value):
    """Write ``value`` into the static buffers ``static`` of the same
    structure: tensors by ``copy_`` (skipped where ``value`` is the static
    tensor itself), Python numbers into tensors by ``fill_``; any other
    value must equal the static one. Raises on another structure or
    shape."""
    if isinstance(static, torch.Tensor):
        if isinstance(value, torch.Tensor):
            if value is not static:
                if value.shape != static.shape:
                    raise ValueError(f"a captured step's buffer has shape {tuple(static.shape)}, "
                                     f"given {tuple(value.shape)}")
                static.copy_(value)
        elif isinstance(value, (bool, int, float)):
            static.fill_(value)
        else:
            raise ValueError(f"a captured step's tensor given {type(value).__name__}")
        return
    if isinstance(static, dict) and isinstance(value, dict) and static.keys() == value.keys():
        for k in static:
            assign(static[k], value[k])
        return
    if (isinstance(static, (tuple, list)) and type(value) is type(static)
            and len(value) == len(static)):
        for s, v in zip(static, value):
            assign(s, v)
        return
    if static != value:
        raise ValueError(f"a captured step reads {static!r} as it was at the capture; given "
                         f"{value!r}: a value that changes per frame must be a tensor")


class CapturedStep:
    """``step(state, inputs) -> (new_state, outputs)`` captured in one CUDA
    graph on the device of ``state``'s tensors (see the module's
    docstring). WARMUP_STEPS eager steps run first on a clone of ``state``.

    ``self.state`` / ``self.outputs``: the static buffers a call returns.
    ``self.capture_seconds``: the capture's host time (the warm-up not
    counted). ``self.pool_bytes``: the device memory the capture reserved
    (the graph's private pool, held for as long as the graph lives)."""

    def __init__(self, step, state, inputs):
        leaves = tree_leaves(state)
        if not leaves or leaves[0].device.type != "cuda":
            raise ValueError("CapturedStep: the state's tensors must lie on a CUDA device")
        dev = leaves[0].device
        self.state = tree_map(torch.clone, state)
        self.inputs = tree_map(torch.clone, inputs)
        torch.cuda.synchronize(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = tree_map(torch.clone, self.state)
            for _ in range(WARMUP_STEPS):
                warm, _ = step(warm, self.inputs)
            del warm
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        # the capture starts by emptying the allocator's cache (torch.cuda.graph);
        # empty it first, so that what it reserves is the graph's pool
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            new_state, outputs = step(self.state, self.inputs)
            if skeleton(new_state) != skeleton(self.state):
                raise ValueError("a captured step must return its state's structure, shapes and "
                                 "Python values unchanged (a Python value that changes per frame "
                                 "would be frozen by the capture)")
            self.outputs = _carry(self.state, new_state, outputs)
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def __call__(self, state, inputs):
        """One replay from ``state`` (copied into the static state unless it
        is that state) on ``inputs``; returns (self.state, self.outputs)."""
        if state is not self.state:
            assign(self.state, state)
        assign(self.inputs, inputs)
        self.graph.replay()
        return self.state, self.outputs


def _carry(static_state, new_state, outputs):
    """Inside the capture: copy ``new_state`` into ``static_state``. A new
    state tensor or an output that shares memory with a static tensor
    the copies overwrite is cloned first, so that every copy reads, and
    every output keeps, the step's value. Returns the outputs."""
    pairs = list(zip(tree_leaves(static_state), tree_leaves(new_state)))
    written = {_ptr(dst) for dst, src in pairs if src is not dst}
    keep = lambda t: t.clone() if _ptr(t) in written else t
    pairs = [(dst, src if src is dst else keep(src)) for dst, src in pairs]
    outputs = tree_map(keep, outputs)
    for dst, src in pairs:
        if src is not dst:
            dst.copy_(src)
    return outputs
