"""The profiler, ported: collective capture of a sharded step on a
DeviceMesh, mesh/link attribution on an H100 topology, the completion cost
model, scope/semantic attribution and the roofline (the front half); and
persistence, sessions, diffs, reports, what-if sweeps, the detectors, the
static lint and synthetic traces (the back half).
"""
from repro_torch.core.events import CollectiveEvent, Trace
from repro_torch.core.roofline import RooflineReport, roofline
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import H100, Hardware, MeshSpec
from repro_torch.core.whatif import Scenario, reannotate, sweep

__all__ = [
    "CollectiveEvent", "Trace", "TraceStore", "TraceSession",
    "Hardware", "MeshSpec", "H100",
    "trace_step",
    "RooflineReport", "roofline",
    "Scenario", "reannotate", "sweep",
]


def __getattr__(name):
    # lazy so `python -m repro_torch.core.session` doesn't import the module twice
    if name == "TraceSession":
        from repro_torch.core.session import TraceSession
        return TraceSession
    # lazy so the host-only back half (sessions, ingest, the watch daemon and
    # its worker processes) does not import torch
    if name == "trace_step":
        from repro_torch.core.capture import trace_step
        return trace_step
    raise AttributeError(name)
