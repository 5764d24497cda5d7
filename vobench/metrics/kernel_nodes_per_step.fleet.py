"""Kernel nodes of the captured step's CUDA graph, child graphs included:
what one replay launches (vobench/reference/graph_nodes.py)."""


def read(r):
    return r.graph_nodes
