"""The port's profiling helpers: ``trace``, ``annotate`` and ``ThroughputMeter``.

``trace`` on the CPU writes a Chrome trace that holds an ``annotate`` span
and the operators inside it; ``ThroughputMeter`` gives the reference's
images/s step for step under one patched clock (the warm-up steps
excluded).
"""

import json
import time

import pytest
import torch

from torch_detection_tpu.engine.profiling import ThroughputMeter as JaxThroughputMeter
from torch_detection_tpu_torch.engine import ThroughputMeter, annotate, trace


def test_trace_writes_a_chrome_trace_holding_an_annotate_span(tmp_path):
    x = torch.ones(64, 64)
    with trace(str(tmp_path / "prof")):
        with annotate("serve_batch"):
            y = (x @ x).relu().sum()
    assert float(y) == 64.0 * 64 * 64
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "serve_batch" and e.get("ph") == "X"]
    assert len(spans) == 1
    span = spans[0]
    inside = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("aten::")
              and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]]
    assert {"aten::mm", "aten::relu", "aten::sum"} <= {e["name"] for e in inside}


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("warmup", [0, 1, 2, 3])
def test_throughput_meter_matches_the_reference(monkeypatch, warmup):
    """Seven steps, a reset after the third; with warm-up 0 the meter never
    starts its clock (the reference's rule), with 3 the first window never
    counts an image."""
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    port, reference = ThroughputMeter(warmup), JaxThroughputMeter(warmup)
    seen = []
    steps = [(8, 0.5), (8, 0.25), (4, 0.125), (8, 1.0), (2, 0.0625), (8, 0.5), (4, 0.25)]
    for i, (batch, dt) in enumerate(steps):
        clock.now += dt
        port.step(batch)
        reference.step(batch)
        seen.append(port.images_per_sec)
        assert port.images_per_sec == reference.images_per_sec
        if i == 2:
            port.reset()
            reference.reset()
    assert (seen[-1] > 0) == (warmup > 0)
