"""Trace reduction (bmfr_tpu/xplane.py) on small synthetic xspace files
laid out like a GPU profile: device planes named ``/device:GPU:<n>``,
one line per CUDA stream, kernels named after their HLO instruction."""

import os

import pytest

from bmfr_tpu import xplane

HLO = """
  %loop_add_fusion.3 = f32[4]{0} fusion(%p), kind=kLoop, metadata={op_name="jit(run)/while/body/k1_accumulate_noisy/add"}
  %pallas_call.0 = f32[3]{0} custom-call(%a), custom_call_target="__gpu$xla.gpu.triton", metadata={op_name="jit(run)/while/body/k2_fitter/bmfr_fused_fit/pallas_call"}
"""


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, value):
    if isinstance(value, int):
        return _varint(num << 3) + _varint(value)
    if isinstance(value, str):
        value = value.encode()
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def _metadata(num, mid, name):
    return _field(num, _field(1, mid) + _field(2, _field(1, mid)
                                               + _field(2, name)))


def _plane(name, lines, names):
    """lines: [(line_name, ts_ns, [(name, offset_ps, dur_ps)])]."""
    ids = {n: i + 1 for i, n in enumerate(names)}
    body = _field(2, name)
    for line_name, ts_ns, events in lines:
        line = _field(2, line_name) + _field(3, ts_ns)
        for n, off, dur in events:
            stat = _field(1, 100) + _field(5, "command_buffer")
            line += _field(4, _field(1, ids[n]) + _field(2, off)
                           + _field(3, dur) + _field(4, stat))
        body += _field(3, line)
    for n, i in ids.items():
        body += _metadata(4, i, n)
    body += _metadata(5, 100, "hlo_op")
    return _field(1, body)


def write_trace(tmp_path, planes):
    d = tmp_path / "plugins" / "profile" / "2026_01_01"
    os.makedirs(d)
    (d / "host.xplane.pb").write_bytes(b"".join(planes))
    return str(tmp_path)


NAMES = ["loop_add_fusion_3", "bmfr_fused_fit__1", "input_concatenate_fusion",
         "python_step"]
MS = 10 ** 9  # picoseconds per millisecond


def gpu_trace(tmp_path):
    gpu = _plane("/device:GPU:0", [
        ("Stream #13(Compute)", 1_000, [
            ("loop_add_fusion_3", 0, 2 * MS),
            ("bmfr_fused_fit__1", 3 * MS, 4 * MS)]),
        # a second stream on the same clock, 1 us later, overlapping
        ("Stream #14(MemcpyD2D)", 1_001, [
            ("input_concatenate_fusion", 5 * MS, 3 * MS)]),
        ("XLA Modules", 1_000, [("python_step", 0, 10 * MS)]),  # not a stream
    ], NAMES)
    host = _plane("/host:CPU", [("python", 0, [("python_step", 0, 50 * MS)])],
                  NAMES)
    return write_trace(tmp_path, [host, gpu])


def test_stage_times_from_gpu_planes(tmp_path):
    per, other, total = xplane.stage_device_times(gpu_trace(tmp_path),
                                                  hlo_text=HLO)
    assert per["k1_accumulate_noisy"] == pytest.approx(2.0)
    assert per["k2_fitter"] == pytest.approx(4.0)   # Pallas kernel by name
    assert other == pytest.approx(3.0)
    # host events and the overview line are not device time
    assert total == pytest.approx(9.0)


def test_busy_and_span_across_streams(tmp_path):
    busy, span = xplane.device_busy_span(gpu_trace(tmp_path))
    # [0, 2] + [3, 7] u [5.000001, 8.000001] ms (the second stream's
    # clock starts 1 ns later)
    assert busy == pytest.approx(2.0 + 5.000001, abs=1e-9)
    assert span == pytest.approx(8.000001, abs=1e-9)


def test_trace_without_device_plane_fails(tmp_path):
    host = _plane("/host:CPU", [("python", 0, [("python_step", 0, MS)])],
                  NAMES)
    with pytest.raises(RuntimeError, match="no GPU device plane"):
        xplane.device_busy_span(write_trace(tmp_path, [host]))
