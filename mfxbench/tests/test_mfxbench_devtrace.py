"""The trace reduction on a hand-made Chrome trace."""

from mfxbench import devtrace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_mfxbench_reduce():
    events = [
        _x("user_annotation", "mfx.sample", 0, 1000),
        _x("user_annotation", "mfx.stage.filter", 10, 400),
        _x("user_annotation", "mfx.op.filter_reads#0", 20, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 2, correlation=1),
        _x("kernel", "k1", 100, 50, correlation=1),
        _x("user_annotation", "mfx.op.viterbi_scan#1", 500, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 505, 2, correlation=2),
        _x("kernel", "k2", 520, 100, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH", 600, 20, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 900, 2, correlation=3),
    ]
    r = devtrace.reduce(events)
    assert r["window_s"] == 1000 / 1e6
    assert r["busy_s"] == (50 + 100) / 1e6          # k2 and the copy overlap
    assert r["op_device_ms"] == {0: 0.05, 1: 0.1}
    assert r["device_ops"][0] == ["k2", 100 / 1e6]
    # the longest gap, 620-1000, lies in no stage; the next, 150-520, in filter
    assert r["idle_gaps"][0] == ["mfx.sample", 380 / 1e6]
    assert r["idle_gaps"][1] == ["mfx.stage.filter", 370 / 1e6]
