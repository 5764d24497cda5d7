"""Kernel nodes of a captured CUDA graph, read through the driver API.

A frozen copy of `chip_smoke.py:1215-1297` (`kept_graphs`,
`_KernelNodeParams`, `NODE_KINDS`, `graph_nodes`), which reads a
`torch.cuda.CUDAGraph` made with `keep_graph=True`: every kernel node,
child graphs included, by the CUDA function's name.  It runs only on a
machine with a card (`libcuda.so.1`).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch


@contextlib.contextmanager
def kept_graphs():
    """Inside the block every torch.cuda.CUDAGraph is made with
    keep_graph=True, so that its captured graph can be read
    (graph_nodes); it is instantiated at its first replay."""
    base = torch.cuda.CUDAGraph

    class Kept(base):
        def __new__(cls, keep_graph=True):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=True):
            super().__init__(True)

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = base


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 of the driver API (cuda.h)
    _fields_ = ([("func", ctypes.c_void_p)]
                + [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx",
                                                 "by", "bz", "smem")]
                + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern",
                                                   "ctx")])


# CUgraphNodeType of the driver API (cuda.h)
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "semaphore_signal", 9: "semaphore_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def graph_nodes(graph) -> tuple[dict, dict]:
    """The nodes of a captured graph (a torch.cuda.CUDAGraph made inside
    kept_graphs), child graphs included: its kernel nodes counted by the
    CUDA function's (mangled) name, what one replay launches, and every
    node counted by kind."""
    cu = ctypes.CDLL("libcuda.so.1")
    P = ctypes.c_void_p

    def ok(res, what):
        if res != 0:
            raise RuntimeError(f"graph_nodes: {what} returned CUresult {res}")

    counts: dict = {}
    kinds: dict = {}

    def walk(g):
        n = ctypes.c_size_t(0)
        ok(cu.cuGraphGetNodes(P(g), None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (P * n.value)()
        ok(cu.cuGraphGetNodes(P(g), nodes, ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int()
            ok(cu.cuGraphNodeGetType(P(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
            name = NODE_KINDS.get(kind.value, str(kind.value))
            kinds[name] = kinds.get(name, 0) + 1
            if name == "graph":
                child = P()
                ok(cu.cuGraphChildGraphNodeGetGraph(P(node),
                                                    ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
                walk(child.value)
            elif name == "kernel":
                p = _KernelNodeParams()
                ok(cu.cuGraphKernelNodeGetParams_v2(P(node), ctypes.byref(p)),
                   "cuGraphKernelNodeGetParams")
                fname = ctypes.c_char_p()
                if p.func:
                    ok(cu.cuFuncGetName(ctypes.byref(fname), P(p.func)),
                       "cuFuncGetName")
                else:
                    ok(cu.cuKernelGetName(ctypes.byref(fname), P(p.kern)),
                       "cuKernelGetName")
                key = fname.value.decode()
                counts[key] = counts.get(key, 0) + 1

    walk(graph.raw_cuda_graph())
    return counts, kinds
