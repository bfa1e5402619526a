"""Graph core: node registry, topological order, delayed edges, JSON IO.

Port of merian_quake_tpu/graph/graph.py. The JAX package traces the
whole frame graph into one jitted program; PyTorch runs eagerly, so
``Graph.run`` is the frame step and ``compile`` returns it.
"""
from __future__ import annotations

import json
from typing import Any, NamedTuple


class InputSpec(NamedTuple):
    """A named input connector; delay=1 reads the previous frame's value
    (the reference's delayed connectors, renderer_restir.hpp:71-84)."""

    name: str
    delay: int = 0
    optional: bool = False


class Node:
    """Base class for graph nodes (≈ merian_nodes::Node).

    Lifecycle: ``inputs()`` / ``outputs()`` declare connectors,
    ``init_state`` allocates persistent device state (history images,
    guiding caches), ``process`` is pure: (ctx, state, inputs) →
    (state', outputs). ``properties`` round-trip through the JSON
    config like the reference's Properties system (configuration.hpp).
    """

    TYPE: str = "node"

    def __init__(self, name: str, props: dict | None = None):
        self.name = name
        self.props = dict(props or {})

    def inputs(self) -> list[InputSpec]:
        return []

    def outputs(self) -> list[str]:
        return []

    def init_state(self, ctx) -> Any:
        return None

    def process(self, ctx, state, **inputs):
        raise NotImplementedError

    def properties(self) -> dict:
        return dict(self.props)


NODE_REGISTRY: dict[str, type[Node]] = {}


def register_node_type(cls: type[Node]):
    NODE_REGISTRY[cls.TYPE] = cls
    return cls


class Graph:
    """A dataflow graph of nodes, run as one frame step.

    ``connections``: list of (src_node, src_output, dst_node, dst_input).
    Delayed inputs read the named output's value from the PREVIOUS
    ``run`` (held in the graph state); frame 0 sees the node's declared
    zero value (None → the consumer must mark the input optional).
    """

    def __init__(self, ctx=None):
        self.nodes: dict[str, Node] = {}
        self.connections: list[tuple[str, str, str, str]] = []
        self.ctx = ctx

    # ---------- construction ----------
    def add_node(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node name {node.name!r}")
        self.nodes[node.name] = node
        return node

    def connect(self, src: str, src_out: str, dst: str, dst_in: str):
        self.connections.append((src, src_out, dst, dst_in))

    # ---------- config IO (≈ ConfigurationManager, configuration.hpp) ----------
    @classmethod
    def from_config(cls, cfg: dict | str, ctx=None) -> "Graph":
        if isinstance(cfg, str):
            with open(cfg) as f:
                cfg = json.load(f)
        g = cls(ctx)
        for name, spec in cfg.get("nodes", {}).items():
            node_cls = NODE_REGISTRY[spec["type"]]
            g.add_node(node_cls(name, spec.get("properties", {})))
        for conn in cfg.get("connections", []):
            g.connect(*conn)
        return g

    def to_config(self) -> dict:
        return {
            "nodes": {
                name: {"type": node.TYPE, "properties": node.properties()}
                for name, node in self.nodes.items()
            },
            "connections": [list(c) for c in self.connections],
        }

    def store(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_config(), f, indent=2)

    # ---------- compile & run ----------
    def _toposort(self) -> list[str]:
        # only non-delayed edges constrain ordering (delayed edges read
        # last frame's value, breaking cycles — the reference's history
        # self-loops work the same way)
        deps: dict[str, set[str]] = {n: set() for n in self.nodes}
        delay_of = {}
        for node in self.nodes.values():
            for spec in node.inputs():
                delay_of[(node.name, spec.name)] = spec.delay
        for src, _, dst, dst_in in self.connections:
            # "$frame" is the pseudo-source for per-frame external inputs
            if src != "$frame" and delay_of.get((dst, dst_in), 0) == 0:
                deps[dst].add(src)
        order, seen, temp = [], set(), set()

        def visit(n):
            if n in seen:
                return
            if n in temp:
                raise ValueError(f"cycle through {n!r} without a delayed edge")
            temp.add(n)
            for d in sorted(deps[n]):
                visit(d)
            temp.discard(n)
            seen.add(n)
            order.append(n)

        for n in sorted(self.nodes):
            visit(n)
        return order

    def init_state(self) -> dict:
        states = {n: node.init_state(self.ctx) for n, node in self.nodes.items()}
        return {"nodes": states, "delayed": {}, "iteration": 0}

    def compile(self):
        """Returns the frame step(state, frame_inputs) → (state, outputs).

        PyTorch runs eagerly: the step is ``run``, launched op by op, as
        the JAX package's graph runs outside ``jax.jit``. Capturing a
        whole frame in a CUDA graph (the counterpart of the JAX package's
        one XLA program) is ROADMAP queue 1, item 8 (f); until then the
        step only keeps the JAX package's contract: a graph with an
        enabled image_write (a host-side node) is refused.
        """
        for node in self.nodes.values():
            if node.TYPE == "image_write" and node.props.get("path"):
                raise ValueError(
                    f"node {node.name!r}: enabled image_write is host-side; "
                    "run the graph eagerly or disable the writer"
                )

        def step(state, frame_inputs):
            return self.run(state, frame_inputs)

        return step

    def run(self, state: dict, frame_inputs: dict | None = None):
        """Execute one frame (topological order; ≈ graph.run(),
        merian-quake.cpp:273-275). Pure apart from host nodes."""
        order = self._toposort()
        produced: dict[tuple[str, str], Any] = {}
        for key, val in (frame_inputs or {}).items():
            produced[("$frame", key)] = val
        in_conns: dict[str, dict[str, tuple[str, str]]] = {}
        for src, src_out, dst, dst_in in self.connections:
            in_conns.setdefault(dst, {})[dst_in] = (src, src_out)

        new_states = dict(state["nodes"])
        new_delayed = {}
        for name in order:
            node = self.nodes[name]
            kwargs = {}
            for spec in node.inputs():
                conn = in_conns.get(name, {}).get(spec.name)
                if conn is None:
                    if not spec.optional:
                        raise ValueError(
                            f"{name}.{spec.name} not connected"
                        )
                    kwargs[spec.name] = None
                    continue
                if spec.delay == 0:
                    kwargs[spec.name] = produced.get(conn)
                else:
                    kwargs[spec.name] = state["delayed"].get(conn)
            new_states[name], outs = node.process(
                self.ctx, state["nodes"].get(name), **kwargs
            )
            for out_name, val in outs.items():
                produced[(name, out_name)] = val

        # snapshot everything a delayed edge might want next frame
        wanted = set()
        for node in self.nodes.values():
            for spec in node.inputs():
                if spec.delay > 0:
                    conn = in_conns.get(node.name, {}).get(spec.name)
                    if conn:
                        wanted.add(conn)
        for key in wanted:
            new_delayed[key] = produced.get(key)

        new_state = {
            "nodes": new_states,
            "delayed": new_delayed,
            "iteration": state["iteration"] + 1,
        }
        return new_state, produced
