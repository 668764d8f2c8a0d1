"""The edges of a captured CUDA graph, by kernel name and dependency type.

A kernel launched with programmatic dependent launch right after another
keeps that in a CUDA graph captured from the stream as a programmatic edge
(`PROGRAMMATIC`) between the two kernel nodes; `kernel_edges` lists every
edge of a `torch.cuda.CUDAGraph(keep_graph=True)` with the kernels' (mangled)
names, read through the CUDA driver (libcuda's graph and function-name
calls). Used by the card checks of the int8 GEMM and attention.
"""

from __future__ import annotations

import ctypes
import functools

import torch

PROGRAMMATIC = 1  # CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC
_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL


class _EdgeData(ctypes.Structure):  # CUgraphEdgeData
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


class _KernelParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.cache
def _driver() -> ctypes.CDLL:
    drv = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p
    drv.cuGraphGetEdges_v2.argtypes = [ptr] * 4 + [ctypes.POINTER(ctypes.c_size_t)]  # CUDA 12.3
    drv.cuGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
    drv.cuGraphKernelNodeGetParams_v2.argtypes = [ptr, ctypes.POINTER(_KernelParams)]
    for name in ("cuFuncGetName", "cuKernelGetName"):
        if hasattr(drv, name):
            getattr(drv, name).argtypes = [ctypes.POINTER(ctypes.c_char_p), ptr]
    return drv


def _check(err: int, call: str) -> None:
    if err:
        raise RuntimeError(f"{call} failed with CUresult {err}")


def node_name(node) -> str:
    """A kernel node's function name, or the node's kind in angle brackets."""
    drv = _driver()
    kind = ctypes.c_int()
    _check(drv.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
    if kind.value != _KERNEL_NODE:
        return f"<node of type {kind.value}>"
    params = _KernelParams()
    _check(drv.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
           "cuGraphKernelNodeGetParams_v2")
    name = ctypes.c_char_p()
    for call, handle in (("cuFuncGetName", params.func), ("cuKernelGetName", params.kern)):
        if handle and hasattr(drv, call) and getattr(drv, call)(ctypes.byref(name), handle) == 0:
            return name.value.decode()
    return "<kernel>"


def kernel_edges(graph: torch.cuda.CUDAGraph) -> list[tuple[str, str, int, int]]:
    """(from node, to node, dependency type, from port) of each edge of a
    graph captured with keep_graph=True, before it is instantiated."""
    drv = _driver()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(drv.cuGraphGetEdges_v2(raw, None, None, None, ctypes.byref(n)), "cuGraphGetEdges_v2")
    src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    data = (_EdgeData * n.value)()
    _check(drv.cuGraphGetEdges_v2(raw, src, dst, data, ctypes.byref(n)), "cuGraphGetEdges_v2")
    return [(node_name(ctypes.c_void_p(a)), node_name(ctypes.c_void_p(b)), e.type, e.from_port)
            for a, b, e in zip(src, dst, data)]
