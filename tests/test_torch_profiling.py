"""Profiling helpers of the port (stvo_pl_tpu_torch/utils/profiling.py) on
the CPU: a torch.profiler trace of a known number of operators, and
hand-written Chrome traces with device events.  The JAX package's
`summarize_trace` parses XLA's xplane protobuf, which needs TensorFlow;
the port's reads torch.profiler's Chrome-trace JSON, so the two are not
run on one trace."""

import json
import os
import time

import pytest
import torch

from stvo_pl_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_device_trace_of_cpu_ops(tmp_path):
    a = torch.ones(64, 64)
    with profiling.device_trace(str(tmp_path / "log")) as prof:
        for _ in range(3):
            a = torch.mm(a, a) * 1e-2
    assert prof is not None
    rows = profiling.summarize_trace(str(tmp_path / "log"), top=None)
    by_name = {name: (ms, n) for name, ms, n in rows}
    assert by_name["aten::mm"][1] == 3 and by_name["aten::mm"][0] > 0
    assert [r[1] for r in rows] == sorted((r[1] for r in rows),
                                          reverse=True)
    assert len(profiling.summarize_trace(str(tmp_path / "log"), top=1)) == 1


def write_trace(path, events, mtime):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    os.utime(path, (mtime, mtime))


def ev(cat, name, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "dur": dur, "ts": 0}


def test_summarize_ranks_device_events_of_the_newest_trace(tmp_path):
    now = time.time()
    newest = [ev("kernel", "fast_pack_kernel(float const*)", 250.0),
              ev("kernel", "extract_kernel(unsigned const*)", 40.0),
              ev("kernel", "extract_kernel(unsigned const*)", 60.0),
              ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 120.0),
              ev("gpu_memset", "Memset (Device)", 5.0),
              ev("cpu_op", "aten::mm", 9000.0),
              ev("cuda_runtime", "cudaLaunchKernel", 800.0),
              ev("kernel", "flow", 1.0, ph="f")]
    write_trace(str(tmp_path / "a" / "old.pt.trace.json"),
                [ev("kernel", "stale_kernel", 1e6)], now - 100)
    write_trace(str(tmp_path / "b" / "new.pt.trace.json"), newest, now)
    write_trace(str(tmp_path / "c" / "other.json"),
                [ev("kernel", "not_a_trace", 1e7)], now + 100)
    rows = profiling.summarize_trace(str(tmp_path))
    assert rows == [("fast_pack_kernel(float const*)", 0.25, 1),
                    ("Memcpy HtoD (Pinned -> Device)", 0.12, 1),
                    ("extract_kernel(unsigned const*)", 0.1, 2),
                    ("Memset (Device)", 0.005, 1)]
    assert profiling.summarize_trace(str(tmp_path), top=2) == rows[:2]
    # with no device events the CPU operators are ranked
    write_trace(str(tmp_path / "d" / "cpu.pt.trace.json"),
                [ev("cpu_op", "aten::add", 30.0),
                 ev("cpu_op", "aten::mm", 70.0),
                 ev("cpu_op", "aten::add", 50.0),
                 ev("python_function", "f", 1e5)], now + 200)
    assert profiling.summarize_trace(str(tmp_path)) == [
        ("aten::add", 0.08, 2), ("aten::mm", 0.07, 1)]


def test_missing_trace_and_timer(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path))
    t = profiling.Timer()
    t.start()
    time.sleep(0.01)
    assert t.stop() >= 10.0 and t.ms >= 10.0
    with profiling.Timer() as t2:
        time.sleep(0.005)
    assert 5.0 <= t2.ms < t.ms + 1e3
