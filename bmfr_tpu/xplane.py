"""XPlane trace parsing: per-stage on-device timings.

The reference reports per-kernel device times from CL events
(opencl/bmfr.cpp:386-412, 488-517; CLUtils.hpp:439-494). The equivalent
here: capture an XLA profiler trace (``profiling.trace``), parse the
``.xplane.pb`` protobuf it writes, and attribute each GPU kernel's duration
to a pipeline stage via the ``jax.named_scope`` annotations the pipeline
carries (bmfr_tpu/pipeline/denoise.py).

The xplane schema is decoded with a minimal protobuf wire-format reader
(no tensorflow/tensorboard dependency): XSpace { planes=1 }, XPlane
{ name=2, lines=3, event_metadata=4 (map), stat_metadata=5 (map) },
XLine { name=2, timestamp_ns=3, events=4 }, XEvent { metadata_id=1, offset_ps=2,
duration_ps=3, stats=4 }, XStat { metadata_id=1, str_value=5,
ref_value=7 }, XEventMetadata / XStatMetadata { id=1, name=2,
display_name=4 }.

Device planes are the ``/device:GPU:<n>`` planes. Their lines are CUDA
streams; an event is one kernel or copy. A fusion's kernel is named after
its HLO instruction with ``.`` written as ``_`` (``%loop_add_fusion.3`` runs
as ``loop_add_fusion_3``); a Pallas kernel carries its own ``name``, which
is also a component of its custom call's ``op_name``. (The ``hlo_op`` stat
names the command buffer that launched the kernel, not the kernel.)
"""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict

#: Stage scope names emitted by the pipeline (jax.named_scope) in
#: reference kernel order (opencl/bmfr.cpp:446-476).
STAGE_SCOPES = (
    "warp_taps",
    "k1_accumulate_noisy",
    "k2_blockify",
    "k2_fitter",
    "k3_weighted_sum",
    "k4_accumulate_filtered",
    "k5_taa",
)

class _Wire:
    def __init__(self, buf, start=0, end=None):
        self.buf = buf
        self.pos = start
        self.end = len(buf) if end is None else end

    def varint(self):
        v = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def fields(self):
        """Yield (field_number, wire_type, value_or_span)."""
        while self.pos < self.end:
            tag = self.varint()
            fnum, wtype = tag >> 3, tag & 7
            if wtype == 0:
                yield fnum, 0, self.varint()
            elif wtype == 1:
                v = self.buf[self.pos : self.pos + 8]
                self.pos += 8
                yield fnum, 1, v
            elif wtype == 2:
                ln = self.varint()
                span = (self.pos, self.pos + ln)
                self.pos += ln
                yield fnum, 2, span
            elif wtype == 5:
                v = self.buf[self.pos : self.pos + 4]
                self.pos += 4
                yield fnum, 5, v
            else:
                raise IOError(f"unsupported wire type {wtype}")


def _parse_event(buf, span):
    md_id = offset_ps = dur_ps = 0
    stats = []
    for fnum, wt, val in _Wire(buf, *span).fields():
        if fnum == 1 and wt == 0:
            md_id = val
        elif fnum == 2 and wt == 0:
            offset_ps = val
        elif fnum == 3 and wt == 0:
            dur_ps = val
        elif fnum == 4 and wt == 2:
            stats.append(_parse_stat(buf, val))
    return md_id, offset_ps, dur_ps, stats


def _parse_stat(buf, span):
    """(stat_metadata_id, str value | ("ref", stat_metadata_id) | None)."""
    md_id, value = 0, None
    for fnum, wt, val in _Wire(buf, *span).fields():
        if fnum == 1 and wt == 0:
            md_id = val
        elif fnum == 5 and wt == 2:
            value = buf[val[0] : val[1]].decode("utf-8", "replace")
        elif fnum == 7 and wt == 0:
            value = ("ref", val)
    return md_id, value


def exclusive_durations(events):
    """events: [(name, offset_ps, dur_ps)] of ONE line. Control-flow ops
    (cond/while) appear as parent events containing their body ops;
    return per-event durations with contained child time subtracted."""
    order = sorted(range(len(events)), key=lambda i: (events[i][1],
                                                      -events[i][2]))
    out = [list(e) + [e[2]] for e in events]  # name, off, dur, exclusive
    stack = []
    for i in order:
        name, off, dur = events[i]
        while stack and off >= events[stack[-1]][1] + events[stack[-1]][2]:
            stack.pop()
        if stack and off + dur <= (events[stack[-1]][1]
                                   + events[stack[-1]][2]):
            out[stack[-1]][3] -= dur   # direct parent loses child's time
        stack.append(i)
    return [(n, o, d, max(x, 0)) for n, o, d, x in out]


def _parse_line(buf, span):
    """-> (name, events) with event offsets made absolute (the line's
    ``timestamp_ns`` plus the event's own ``offset_ps``), so events of
    different streams share one clock."""
    name = ""
    ts_ps = 0
    events = []
    for fnum, wt, val in _Wire(buf, *span).fields():
        if fnum == 2 and wt == 2:
            name = buf[val[0] : val[1]].decode("utf-8", "replace")
        elif fnum == 3 and wt == 0:
            ts_ps = val * 1000
        elif fnum == 4 and wt == 2:
            events.append(_parse_event(buf, val))
    return name, [(md, ts_ps + off, dur, st) for md, off, dur, st in events]


def _parse_event_metadata(buf, span):
    md_id = 0
    name = display = ""
    for fnum, wt, val in _Wire(buf, *span).fields():
        if fnum == 1 and wt == 0:
            md_id = val
        elif fnum == 2 and wt == 2:
            name = buf[val[0] : val[1]].decode("utf-8", "replace")
        elif fnum == 4 and wt == 2:
            display = buf[val[0] : val[1]].decode("utf-8", "replace")
    return md_id, (display or name)


def _parse_plane(buf, span):
    """-> (name, lines, meta) where ``lines`` is ``[(line_name,
    [(event_name, offset_ps, dur_ps, {stat_name: str})])]``."""
    name = ""
    raw_lines = []
    meta = {}
    stat_names = {}
    for fnum, wt, val in _Wire(buf, *span).fields():
        if fnum == 2 and wt == 2:
            name = buf[val[0] : val[1]].decode("utf-8", "replace")
        elif fnum == 3 and wt == 2:
            raw_lines.append(_parse_line(buf, val))
        elif fnum in (4, 5) and wt == 2:
            # map entry { key=1, value=2 (XEventMetadata/XStatMetadata) }
            for f2, w2, v2 in _Wire(buf, *val).fields():
                if f2 == 2 and w2 == 2:
                    mid, mname = _parse_event_metadata(buf, v2)
                    (meta if fnum == 4 else stat_names)[mid] = mname

    def stat_dict(stats):
        out = {}
        for sid, value in stats:
            if isinstance(value, tuple):
                value = stat_names.get(value[1])
            if value is not None:
                out[stat_names.get(sid, str(sid))] = value
        return out

    lines = [(line_name,
              [(meta.get(md, str(md)), off, dur, stat_dict(stats))
               for md, off, dur, stats in events])
             for line_name, events in raw_lines]
    return name, lines, meta


def parse_xspace(path):
    """Parse one .xplane.pb file -> list of (plane_name, lines, meta)."""
    with open(path, "rb") as f:
        buf = f.read()
    planes = []
    for fnum, wt, val in _Wire(buf).fields():
        if fnum == 1 and wt == 2:
            planes.append(_parse_plane(buf, val))
    return planes


def is_device_plane(name):
    return name.startswith("/device:GPU:")


def find_xplane_files(logdir):
    return sorted(glob.glob(
        os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb")))


def device_lines(logdir):
    """Yield ``(plane_name, line_name, events)`` for every kernel line of
    every device plane; ``events`` are ``(op_text, offset_ps, dur_ps,
    inst_name)``. Raises if the trace holds no device plane, so a run
    that traced nothing on the device fails instead of reading empty."""
    found = False
    for path in find_xplane_files(logdir):
        for name, lines, _meta in parse_xspace(path):
            if not is_device_plane(name):
                continue
            found = True
            for line_name, events in lines:
                # kernels and copies live on the CUDA stream lines; any
                # other line would count them twice
                if not line_name.startswith("Stream"):
                    continue
                yield name, line_name, [
                    (" ".join([n] + [v for v in st.values()
                                     if isinstance(v, str)]),
                     off, dur, n)
                    for n, off, dur, st in events]
    if not found:
        raise RuntimeError(f"no GPU device plane in the trace at {logdir}")


def device_op_durations(logdir, exclusive=True):
    """Device op events: list of ``(op_text, duration_ps, inst_name)``.

    With ``exclusive`` the durations of parent events that contain others
    on the same line have their children subtracted, so the totals count
    device time exactly once.
    """
    out = []
    for _plane, _line, events in device_lines(logdir):
        named = [(t, off, dur) for t, off, dur, _i in events]
        insts = [i for _t, _o, _d, i in events]
        if exclusive:
            for (n, _o, _d, x), inst in zip(exclusive_durations(named),
                                             insts):
                out.append((n, x, inst))
        else:
            for (n, _o, d), inst in zip(named, insts):
                out.append((n, d, inst))
    return out


def device_busy_span(logdir):
    """(busy_ms, span_ms): the union of device op intervals vs the wall
    span (first op start to last op end) over all device lines.
    ``span - busy`` is device idle — dispatch gaps and launch tails — which
    per-op attribution can never show."""
    intervals = []
    for _plane, _line, events in device_lines(logdir):
        intervals += [(off, off + dur) for _t, off, dur, _i in events]
    if not intervals:
        return 0.0, 0.0
    intervals.sort()
    busy = 0
    cur_lo, cur_hi = intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    span = max(h for _l, h in intervals) - intervals[0][0]
    return busy / 1e9, span / 1e9


def scope_map_from_hlo(hlo_text, scopes=STAGE_SCOPES):
    """kernel name -> stage scope, parsed from compiled HLO text (the
    trace's kernel events carry no op_name; the metadata lives in the
    compiled module). Keys are instruction names in their kernel spelling
    (``.`` -> ``_``) and the names of Pallas kernels."""
    out = {}
    for m in re.finditer(
            r"%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"", hlo_text):
        inst, op_name = m.group(1), m.group(2)
        scope = next((s for s in scopes if s in op_name), None)
        if scope is None:
            continue
        out[inst.replace(".", "_")] = scope
        parts = op_name.split("/")
        if parts[-1] == "pallas_call" and len(parts) > 1:
            out[parts[-2]] = scope
    return out


def stage_device_times(logdir, scopes=STAGE_SCOPES, hlo_text=None):
    """Aggregate exclusive device op durations by pipeline stage scope.

    Attribution: the op's instruction name (its ``hlo_op`` stat) is looked
    up in the compiled module's op_name metadata (``hlo_text``); ops
    without a match fall back to substring search in the event text. Returns
    ``(per_stage_ms, other_ms, total_ms)``.
    """
    smap = scope_map_from_hlo(hlo_text, scopes) if hlo_text else {}
    per = defaultdict(float)
    other = 0.0
    total = 0.0
    for op_text, dur_ps, inst in device_op_durations(logdir):
        ms = dur_ps / 1e9
        total += ms
        # repeated launches of one Pallas kernel get a "__<n>" suffix
        scope = smap.get(inst) or smap.get(re.sub(r"__\d+$", "", inst))
        if scope is None:
            for s in scopes:
                if s in op_text:
                    scope = s
                    break
        if scope is None:
            other += ms
        else:
            per[scope] += ms
    ordered = {s: per.get(s, 0.0) for s in scopes}
    return ordered, other, total
