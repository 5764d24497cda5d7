"""Captured programs: the port's counterpart of the JAX package's `jax.jit`
entry points (`vo_step_batched` with `donate_argnums=(0,)`, `vo_step`,
`refine_window_auto`, ...).

    prog = Compiled(fn, device)          # fn: tensors (and NamedTuples of
    out = prog(*args)                    # them, None allowed) -> the same

On CUDA the first call for a static key (the structure, shapes, dtypes
and devices of the arguments; everything else `fn` closes over, as jit's
static arguments) copies the arguments into static buffers, runs `fn`
once on a side stream (the warm-up: it loads the kernel library, builds
the cached device constants, creates the cuBLAS / cuSOLVER handles and
sets the kernels' shared-memory attributes) and captures one more run as
a CUDA graph into the graph's private memory pool.  Every call then
copies its arguments in, replays the graph and returns fresh clones of
the outputs, so what a call returns belongs to the caller and no later
call changes it; the arguments themselves are never written (the input
state is free to reuse, which is all that jit's donation promises).  A
capture or replay that fails raises: there is no eager fallback on the
card.  A program holds no reference back to its `Compiled`, so one that
is dropped is freed at once by reference counting, never by the garbage
collector inside another program's capture, which freeing its graph and
pool would invalidate.

On the CPU, where there is no graph and only because the caller asked
for the CPU, the same object runs `fn` eagerly on the same static
buffers and returns clones in the same way.

Kernel launches.  The kernel wrappers count their launches in Python
(`fast_pack.launches`, ...), where they launch: the warm-up's and the
capture's calls count, and a replay, which runs no Python, adds nothing.
`_Program.replays` counts the replays on the host, and the device counter
of the program's stage ring (below) counts them on the device; the
captured graph's kernel nodes say what each one launches, the six stamp
kernels of a stamped step included.

Stages.  A program owns a `utils/profiling.StageRing`: its warm-up and
its capture (on the CPU every run) are `stamping` blocks, so the
`profiling.stamp` calls of the body are captured as stamp kernels, and
each replay writes the device clock at every stage boundary into its own
row of the ring (4096 rows), with no host sync, copy or argument.
`stages()` reads the rows back with one copy, only when called; a body
that stamps nothing (the `compile_fn` programs) reports no names.

Host spans.  A call is the `torch.profiler.record_function` span
`stvo.call`, with `stvo.copy_in`, `stvo.replay` (on the CPU the eager
run) and `stvo.clone_out` inside it: under a profiler they lie on the
clock of the device's events; without one each costs a few microseconds
of host time and launches nothing.

Constants.  A graph reads the device constants of its capture by address
and holds no reference to them, so the program holds every value of the
per-device caches (`device.device_cache`) that its first run read.

Collectives.  A program whose body runs collectives (the sharded step's
TP all-gathers, the sharded BA's all-reduces) names their process groups
in `groups`.  The warm-up makes the first collective, which creates the
NCCL communicator, and the device is synchronized before the capture, so
none of the warm-up's work is in flight while the capture runs.  A graph
holds the communicator's kernels and buffers by address, so a program
must not outlive its groups: every call first checks that each group is
still registered and raises if `destroy_process_group` has removed it,
on the CPU too.  Destroying a group does not release its programs, so a
caller drops them (and synchronizes) before `destroy_process_group`.
The capture keeps torch's default "global" error mode: no capture with
collectives failed in it, in an NCCL world of one H100 or of four
(PERF.md §6).
"""

from __future__ import annotations

import inspect

import torch
import torch.distributed as dist
from torch.profiler import record_function

from stvo_pl_tpu_torch.device import owning, resolve_device
from stvo_pl_tpu_torch.utils.profiling import StageRing, stamping


def _flatten(tree, leaves: list):
    """Spec of a tree of tensors, (Named)tuples and None; appends the
    tensors to `leaves` in order."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "T"
    if isinstance(tree, tuple):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    raise TypeError(f"Compiled takes tensors, tuples of them and None, not "
                    f"{type(tree).__name__}")


def _unflatten(spec, leaves):
    if spec is None:
        return None
    if spec == "T":
        return next(leaves)
    kind, children = spec
    items = [_unflatten(c, leaves) for c in children]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


class _Program:
    """One program: static buffers, on CUDA the graph, the device
    constants its first run read (`owned`) and the ring of its stage
    stamps (`ring`)."""

    def __init__(self, fn, device, spec, leaves):
        self.fn, self.device = fn, device
        self.static_in = [torch.empty_like(x, device=device)
                          for x in leaves]
        self.static_args = _unflatten(spec, iter(self.static_in))
        self.graph = None
        self.replays = 0
        self.owned: dict = {}
        self.ring = StageRing(device)
        self.out_spec = self.out_leaves = None

    def _keep(self, out):
        self.out_leaves = []
        self.out_spec = _flatten(out, self.out_leaves)

    def capture(self):
        """Warm up on a side stream, then capture one run of fn.  The
        warm-up's stamps fix the ring's names; the ring is allocated on
        the caller's stream once the warm-up has left the side stream."""
        fn, args = self.fn, self.static_args
        with torch.cuda.device(self.device), owning(self.owned):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with stamping(self.ring), torch.cuda.stream(side):
                fn(*args)                               # the warm-up
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph), stamping(self.ring):
                out = fn(*args)
        self._keep(out)
        self.graph = graph

    def run(self, leaves):
        with record_function("stvo.copy_in"):
            for s, x in zip(self.static_in, leaves):
                s.copy_(x, non_blocking=True)
        with record_function("stvo.replay"):
            if self.graph is not None:
                self.graph.replay()
                self.replays += 1
            else:
                with owning(self.owned), stamping(self.ring):
                    self._keep(self.fn(*self.static_args))
        with record_function("stvo.clone_out"):
            return _unflatten(self.out_spec,
                              iter([t.clone() for t in self.out_leaves]))

    def stages(self) -> tuple[list, torch.Tensor]:
        """(names, ns): the stamps of the most recent runs (on CUDA the
        replays), ns int64 [min(runs, 4096), len(names)] in nanoseconds,
        oldest first (utils/profiling.StageRing.stages)."""
        return self.ring.stages()


class Compiled:
    """`fn` as a captured program on `device` ("cuda" unless the caller
    asks for the CPU); `groups`: the process groups of the collectives
    that `fn` runs.  See the module's docstring."""

    def __init__(self, fn, device=None, groups=()):
        self.fn = fn
        self.device = resolve_device(device)
        self.groups = tuple(groups)
        self.programs: dict = {}    # static key -> _Program

    def __call__(self, *args):
        with record_function("stvo.call"):
            return self._call(args)

    def _call(self, args):
        for group in self.groups:
            try:
                dist.get_rank(group)
            except (ValueError, RuntimeError) as e:
                raise RuntimeError(
                    "a compiled program outlived its process group: drop "
                    "it before destroy_process_group()") from e
        leaves = []
        spec = _flatten(args, leaves)
        key = spec, tuple((tuple(x.shape), x.dtype) for x in leaves)
        prog = self.programs.get(key)
        if prog is None:
            prog = _Program(self.fn, self.device, spec, leaves)
            if self.device.type == "cuda":
                for s, x in zip(prog.static_in, leaves):
                    s.copy_(x)
                prog.capture()
            self.programs[key] = prog
        return prog.run(leaves)

    def stages(self) -> tuple[list, torch.Tensor]:
        """`_Program.stages()` of the one program this object holds."""
        if len(self.programs) != 1:
            raise ValueError(f"stages() reads a Compiled of one program; "
                             f"this one has {len(self.programs)}")
        (prog,) = self.programs.values()
        return prog.stages()


def compile_fn(fn, argnames: tuple, device=None, **static) -> Compiled:
    """`fn` as a captured program on `device` ("cuda" unless the caller
    asks for the CPU), the counterpart of `jax.jit(fn, static_argnames=...)`
    for one tuple of static values: `static` (JAX's static arguments) are
    passed to every call by keyword and fixed for the program's life,
    `argnames` (JAX's traced arguments) are the program's own arguments,
    given by position (tensors, NamedTuples of them or None; trailing ones
    may be left out and take `fn`'s defaults):

        prog = compile_fn(knn_match, ("query", "index", "q_valid"), k=2)
        prog(query, index)      # == knn_match(query, index, k=2)

    A number that may change from call to call (a threshold that JAX
    traces, as `detect_line_segments`' `min_length`) belongs in `argnames`
    as a 0-d tensor: a Python number closed over is frozen into the
    graph."""
    clash = set(argnames) & set(static)
    if clash:
        raise TypeError(f"{fn.__name__}: {sorted(clash)} are the program's "
                        f"arguments, not static ones")
    inspect.signature(fn).bind_partial(**static)    # unknown names raise

    def body(*args):
        if len(args) > len(argnames):
            raise TypeError(f"{fn.__name__}: at most {len(argnames)} "
                            f"arguments {argnames}, got {len(args)}")
        return fn(**dict(zip(argnames, args)), **static)
    body.__name__ = body.__qualname__ = fn.__name__
    return Compiled(body, device)
