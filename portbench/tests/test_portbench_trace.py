"""The traced run's reading on a made-up Chrome trace: kernels named to their
layers, the busy share, the idle gaps by host activity, and readers that find
nothing to read return nothing."""
import json

import pytest

from portbench import spec, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


EVENTS = [
    _x(trace.UNIT, "user_annotation", 1000, 100),
    _x("aten::linear", "cpu_op", 1000, 10),
    _x("cudaStreamSynchronize", "cuda_runtime", 1060, 40),
    _x("void (anonymous namespace)::pair_bwd_kernel<false, 5, false, 1, 7>(Shape, Tensors, "
       "BwdPlan)", "kernel", 1010, 30),
    _x("void (anonymous namespace)::reduce_partials_kernel(float const*, int, int, float*)",
       "kernel", 1040, 5),
    _x("void (anonymous namespace)::reduce_kernel(float const*, int, long long, long long, int,"
       " long long, Scratch, float*)", "kernel", 1045, 5),
    _x("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)", "kernel",
       1050, 5),
    _x("void (anonymous namespace)::knn_select_block_kernel<0, 1, 1, 3, true, true, 2>()",
       "kernel", 1070, 10),
    _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1090, 5),
    _x(trace.UNIT, "user_annotation", 1200, 100),
    _x("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n", "kernel", 1210, 20),
]


@pytest.fixture
def reading(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return trace.read(str(path), units=2)


def test_layers(reading):
    assert reading.layer_s["pair_bwd"] == pytest.approx(35e-6)
    assert reading.layer_s["segment"] == pytest.approx(5e-6)
    assert reading.layer_s["knn"] == pytest.approx(10e-6)
    assert reading.layer_s["torch"] == pytest.approx(25e-6)


def test_window_busy_gaps(reading):
    assert reading.window_s == pytest.approx(300e-6)
    # kernels 1010-1055 merged, 1070-1080, the copy 1090-1095, 1210-1230
    assert reading.busy_s == pytest.approx((45 + 10 + 5 + 20) * 1e-6)
    assert reading.unit_spans[0] == pytest.approx((1000e-6, 1100e-6, 60e-6))
    gaps = dict(reading.breakdown["idle_gaps"])
    assert gaps["aten::linear"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(15e-6 + 10e-6)
    assert gaps["host idle"] == pytest.approx(115e-6 + 70e-6)
    names = [n for n, _ in reading.breakdown["device_ops"]]
    assert names[0] == "pair_bwd_kernel"


def test_readers_on_the_trace(reading):
    read = lambda m: spec.reader(m)(reading)  # noqa: E731
    assert read("pair_ms.train") == pytest.approx(1e3 * 35e-6 / 2)
    assert read("segment_ms.train") == pytest.approx(1e3 * 5e-6 / 2)
    assert read("idle_share.train") == pytest.approx(100 * (1 - 80 / 300))
    # serving: inside the two requests' spans, 60 and 20 of 200 us busy
    assert read("idle_share.serve") == pytest.approx(100 * (1 - 80 / 200))
    assert read("host_gap_ms.serve") == pytest.approx(1e3 * ((100 - 60) + (100 - 20)) * 1e-6 / 2)
    assert read("k10f_roofline.serve") is None     # no K10f in the trace


def test_nothing_to_read_returns_nothing(reading):
    reading.busy_s, reading.layer_s = 0.0, {}
    for m in spec.benchmark()["per_layer"]:
        assert spec.reader(m["name"])(reading) is None, m["name"]
