"""Declarative frame graph with typed connectors and delayed edges.

Port of merian_quake_tpu/graph (≈ merian's ``merian_nodes::Graph<>``):
nodes declare named inputs/outputs, connections wire them (with an
optional one-frame delay — the reference's ``("prev_gbuffer", 1)``
connectors and history self-loops), the graph topologically orders the
nodes and runs them as one frame step over (persistent node states,
frame inputs). The JSON config is the pipeline definition, exactly like
res/default_config.json in the reference (res/default_graph.json and
res/pt_graph.json load as they are). PyTorch runs the step eagerly.
"""
from .graph import Graph, Node, InputSpec  # noqa: F401
from . import nodes  # noqa: F401  (registers built-in node types)
