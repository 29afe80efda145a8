"""The port's tracing fence: a fenced span over CPU tensors records its event
and does not synchronise a card; telemetry off makes it a no-op."""
import pytest
import torch

from repro_torch import obs
from repro_torch.obs import tracing


@pytest.fixture
def tracer():
    tr = obs.install_tracer()
    yield tr
    obs.uninstall_tracer()
    obs.disable()


def test_fenced_span_over_cpu_tensors_does_not_sync(tracer, monkeypatch):
    def no_sync():
        raise AssertionError("synchronised for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    with obs.fenced_span("step") as fence:
        out = fence({"logits": torch.ones(3), "cache": [torch.zeros(2)]})
    assert out["logits"].sum() == 3
    (ev,) = tracer.events()
    assert ev["name"] == "step" and ev["cat"] == "cuda" and ev["dur"] >= 0


def test_on_cuda_walks_nested_outputs():
    assert not tracing._on_cuda([torch.ones(1), {"a": (torch.ones(1),)}])
    assert not tracing._on_cuda("not a tensor")


def test_fenced_span_is_a_noop_when_telemetry_is_off():
    obs.disable()
    span = obs.fenced_span("off")
    assert span.tracer is None and not span.fenced
