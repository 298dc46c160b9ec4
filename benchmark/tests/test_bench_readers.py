"""The per-layer arithmetic on synthetic records, against counts and
shares worked out by hand."""
import pytest

from cnbench import manifest, readers, trace
from roofline import kernels, peaks


def rec(**kw):
    base = {"window_s": 1.0, "busy_s": 0.75, "steps": 2, "images": 8,
            "kernels": [("conv_fprop", 0.0, 0.3), ("mish_kernel", 0.3, 0.1),
                        ("peak_rows_kernel", 0.5, 0.002), ("peak_rows_kernel", 0.6, 0.002),
                        ("batch_norm_transform_input", 0.7, 0.05)]}
    base.update(kw)
    return base


def test_idle_share_from_intervals():
    spans = [(0.0, 0.2), (0.1, 0.3), (0.5, 0.6), (0.6, 0.65)]
    assert trace.merge(spans) == [(0.0, 0.3), (0.5, 0.65)]
    assert trace.union_length(spans) == pytest.approx(0.45)
    assert readers.idle_share(rec(busy_s=0.45)) == pytest.approx(55.0)
    assert readers.idle_share(rec(kernels=[])) is None


def test_rate_over_the_window_mfu():
    r = rec(flops_per_image=1e12, images=100, window_s=2.0)
    assert readers.mfu(r, 1) == pytest.approx(100 * 1e12 * 100 / 2.0 / peaks.BF16_FLOPS)
    assert readers.mfu(r, 3) == pytest.approx(3 * readers.mfu(r, 1))
    assert readers.mfu(rec(), 1) is None


def test_counters_against_hand_counts():
    r = rec()
    assert readers.kernels_per_step(r) == pytest.approx(2.5)
    share = readers.kernel_share(r, readers.NORM_ACT)
    assert share == pytest.approx(100 * 0.15 / 0.454)


def test_peak_roofline_by_hand():
    r = rec(heatmaps=[((64, 80, 128, 128), 2)] * 2)
    n, h, w, c = 64, 128, 128, 80
    moved = n * h * w * c * 2 + n * h * w * 8
    least = max(moved / peaks.HBM_BYTES_PER_S, n * h * w * c * 10 / peaks.F32_OPS)
    assert kernels.peak_decode_s(n, h, w, c, 2) == pytest.approx(least)
    got = manifest.metric_reader("peak_decode_roofline")(r)
    assert got == pytest.approx(100 * 2 * least / 0.004)


def test_dcn_sample_roofline_by_hand():
    shapes = [((128, 128, 32, 32), "torch.bfloat16"), ((128, 128, 64, 64), "torch.bfloat16")]
    r = rec(kernels=[("dcn_sample_kernel", 0.0, 0.001), ("dcn_sample_kernel", 0.1, 0.003)],
            dcn_inputs=shapes)
    each = [kernels.dcn_sample_s(128, 32, 32, 128, 2), kernels.dcn_sample_s(128, 64, 64, 128, 2)]
    moved = 128 * 64 * 64 * (128 * 2 + 9 * 5 * 4 + 9 * 128 * 2)
    assert each[1] >= moved / peaks.HBM_BYTES_PER_S
    got = manifest.metric_reader("dcn_sample_roofline")(r)
    assert got == pytest.approx(100 * 2 * (sum(each) / 2) / 0.004)


def test_readers_return_nothing_without_records():
    for m in manifest.manifest()["per_layer"]:
        assert manifest.metric_reader(m["name"])({}) is None


def test_breakdown_names_gaps_by_host_op():
    r = {"window_s": 1.0, "kernels": [("a", 0.1, 0.2), ("b", 0.5, 0.1)],
         "busy_spans": [(0.1, 0.3), (0.5, 0.6)],
         "host_ops": [("outer", 0.0, 1.0), ("inner_wait", 0.3, 0.5)]}
    out = trace.breakdown(r)
    assert out["device_ops"][0] == ["a", 0.2]
    gaps = dict(out["idle_gaps"])
    assert gaps["inner_wait"] == pytest.approx(0.2)
    assert gaps["outer"] == pytest.approx(0.1 + 0.4)
