"""The program's spans in a trace (``progtrace``) and the metrics that read
them, on small synthetic traces: device time inside nested spans, idle
time at a span's edges, a span with no device work, and None from every
reader where its span is absent or there is no trace."""

import types

import pytest

import devtrace
import harness
import progtrace

# a 100 us window: pst.field [10, 60] holding pst.field.deposit [12, 30]
# and pst.field.fits_readback [30, 50], then pst.mobility [60, 90] and a
# second pst.field [90, 96] with no device work
HOST = [
    (0.0, 100.0, "bench.window"),
    (10.0, 60.0, "pst.field"),
    (12.0, 30.0, "pst.field.deposit"),
    (14.0, 16.0, "cudaLaunchKernel"),
    (30.0, 50.0, "pst.field.fits_readback"),
    (35.0, 48.0, "cudaStreamSynchronize"),
    (60.0, 90.0, "pst.mobility"),
    (90.0, 96.0, "pst.field"),
]
DEVICE = [
    ("deposit", 20.0, 32.0),   # starts in the deposit, ends past it
    ("amax", 40.0, 45.0),      # inside the readback
    ("engine", 70.0, 85.0),    # inside the mobility span
    ("late", 97.0, 99.0),      # after every span
]
# idle: [0, 20), [32, 40), [45, 70), [85, 97), [99, 100)
METRICS = ("setup_particles_ms", "field_device_ms", "field_idle_ms",
                 "mobility_idle_ms")


def _trace(host=HOST, device=DEVICE):
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    return devtrace.Trace((0.0, 100.0), list(device), {}, host)


def _readings(trace):
    return types.SimpleNamespace(trace=trace)


def test_device_time_inside_nested_spans():
    t = _trace()
    assert progtrace.count(t, "pst.field") == 2
    assert progtrace.device_s_in(t, "pst.field") == pytest.approx(17e-6)
    assert progtrace.device_s_in(t, "pst.field.deposit") == pytest.approx(
        12e-6)
    assert progtrace.device_s_in(t, "pst.field.fits_readback") == (
        pytest.approx(5e-6))
    assert progtrace.device_s_in(t, "pst.mobility") == pytest.approx(15e-6)
    assert harness.reader("field_device_ms")(_readings(t)) == pytest.approx(
        17e-3 / 2)
    by = progtrace.breakdown(t)["device_s_by_innermost"]
    assert by == pytest.approx({"pst.field.deposit": 12e-6,
                                "pst.field.fits_readback": 5e-6,
                                "pst.mobility": 15e-6, "none": 2e-6})


def test_idle_overlap_at_span_edges():
    """A gap that starts before a span or ends after it counts only the
    part inside; the innermost span takes each part."""
    t = _trace()
    # pst.field [10, 60]: [10, 20) + [32, 40) + [45, 60); [90, 96]: 6
    assert progtrace.idle_s_in(t, "pst.field") == pytest.approx(39e-6)
    # pst.mobility [60, 90]: [60, 70) + [85, 90)
    assert progtrace.idle_s_in(t, "pst.mobility") == pytest.approx(15e-6)
    assert harness.reader("field_idle_ms")(_readings(t)) == pytest.approx(
        39e-3 / 2)
    assert harness.reader("mobility_idle_ms")(_readings(t)) == (
        pytest.approx(15e-3))
    b = progtrace.breakdown(t)
    assert b["idle_s_by_innermost"] == pytest.approx({
        "none": 12e-6,                         # [0, 10), [96, 97), [99, 100)
        "pst.field": 18e-6,                    # [10, 12), [50, 60), [90, 96)
        "pst.field.deposit": 8e-6,             # [12, 20)
        "pst.field.fits_readback": 13e-6,      # [32, 40), [45, 50)
        "pst.mobility": 15e-6,                 # [60, 70), [85, 90)
    })
    by_event = dict(b["idle_s_by_host_event"])
    assert by_event["pst.field.fits_readback/cudaStreamSynchronize"] == (
        pytest.approx(8e-6))
    assert sum(by_event.values()) == pytest.approx(66e-6)


def test_a_span_with_no_device_work():
    """The second field span holds no device operation: it adds its idle
    time and its count, and no device time; a trace whose only field span
    is idle reads 0 device ms and its whole length idle."""
    only = _trace(host=[(0.0, 100.0, "bench.window"),
                        (90.0, 96.0, "pst.field")])
    assert progtrace.device_s_in(only, "pst.field") == 0.0
    assert harness.reader("field_device_ms")(_readings(only)) == 0.0
    assert harness.reader("field_idle_ms")(_readings(only)) == (
        pytest.approx(6e-3))
    spans = progtrace.breakdown(_trace())["spans"]
    assert spans["pst.field"]["count"] == 2
    assert spans["pst.field"]["span_ms"] == pytest.approx((50 + 6) / 2e3)


@pytest.mark.parametrize("name", METRICS)
def test_readers_return_none_without_their_span(name):
    """No trace, or a trace of a program without the spans (the benchmark
    spans only, as an older checkout records): None, as the other readers
    do with no trace."""
    read = harness.reader(name)
    assert read(_readings(None)) is None
    bare = _trace(host=[h for h in HOST if not h[2].startswith("pst.")])
    assert read(_readings(bare)) is None


def test_setup_reads_its_own_span():
    t = _trace(host=HOST + [(2.0, 9.0, "pst.setup")],
               device=DEVICE + [("threefry", 3.0, 8.0)])
    assert harness.reader("setup_particles_ms")(_readings(t)) == (
        pytest.approx(5e-3))
