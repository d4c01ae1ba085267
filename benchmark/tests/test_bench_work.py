"""The roofline shares' work counts against hand counts, and the trace
reduction on a made-up trace."""
import pytest

from benchmark import core, trace, work


def test_segment_ops_by_hand():
    # 10 segments of 4 paths: at least 6 hits, the other 4 the sky (17).
    # A sphere hit: test 34, hit record 22, draws 3 x 13 + 11, scatter 15.
    assert work.segment_ops(10, 4, triangles=False) == (
        10 * 6 + 6 * (34 + 22 + 50 + 15) + 4 * 17)
    assert work.segment_ops(10, 4, triangles=True) == (
        10 * 6 + 6 * (54 + 22 + 50 + 15) + 4 * 17)
    # No draws in the adjoint, two operations for each forward one.
    assert work.adjoint_ops(10, 4, triangles=False) == 2 * (
        10 * 6 + 6 * (34 + 22 + 15) + 4 * 17)
    # Fewer segments than paths: none is surely a hit.
    assert work.segment_ops(3, 4, triangles=False) == 3 * 6 + 3 * 17


def test_bytes_by_hand():
    run = dict(width=4, height=2, spp=1, n_spheres=3, n_triangles=5,
               n_materials=2)
    assert work.scene_bytes(run) == 3 * 32 + 5 * 40 + 2 * 24 + 21 * 4
    assert work.image_bytes(run) == 4 * 2 * 12
    assert work.grad_bytes(run) == 3 * 48 + 5 * 56


def fake_trace(counts):
    ms = 1_000_000
    device = [("void (anonymous namespace)::megakernel<false>(float4 const*)",
               0, 3 * ms),
              ("void at::native::copy_kernel<float>(int)", 4 * ms, 5 * ms),
              ("void (anonymous namespace)::megakernel<false>(float4 const*)",
               6 * ms, 9 * ms)]
    host = [("bench.window", 0, 10 * ms), ("bench.render", 0, 5 * ms),
            ("aten::copy_", 3 * ms, 4 * ms), ("cudaStreamSynchronize",
                                              9 * ms, 10 * ms)]
    run = dict(width=4, height=2, spp=1, max_depth=2, n_spheres=3,
               n_triangles=0, n_materials=2)
    return trace.Trace(device, host, (0, 10 * ms), units=2, counts=counts,
                       run=run)


def test_trace_reduction():
    t = fake_trace({"k1_steps": 40})
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.007)
    assert t.kernel_s(r"megakernel<") == pytest.approx(0.006)
    assert t.kernel_s(r"flat_bounce") is None
    assert t.top_ops()[0] == ["(anonymous namespace)::megakernel<false>",
                              pytest.approx(0.006)]
    gaps = dict(t.idle_gaps())
    assert gaps == {"aten::copy_": pytest.approx(0.001),
                    "bench.window": pytest.approx(0.001),
                    "cudaStreamSynchronize": pytest.approx(0.001)}


def test_roofline_share_by_hand():
    t = fake_trace({"k1_steps": 40})
    k1 = core.load_module(core.HERE / "metrics" / "k1_roofline_pct.py", "k1r")
    samples, segments = 8, 20  # per frame
    ops = samples * work.OPS_CAMERA + work.segment_ops(segments, samples,
                                                       False)
    least = max(ops / work.PEAK_F32, (3 * 32 + 2 * 24 + 84 + 96)
                / work.PEAK_BYTES)
    assert k1.read(t) == pytest.approx(100 * least / 0.003)
    assert k1.read(fake_trace({})) is None
    idle = core.load_module(core.HERE / "metrics"
                            / "device_idle_pct.render.py", "idle")
    assert idle.read(t) == pytest.approx(30.0)
    other = core.load_module(core.HERE / "metrics"
                             / "wavefront.other_device_ms.py", "other")
    assert other.read(t) is None
