"""The profiler's front half, ported: collective capture of a sharded step
on a DeviceMesh, mesh/link attribution on an H100 topology, the completion
cost model, scope/semantic attribution and the roofline.  The back half
(persist, diff, report, session, watch, whatif, detectors) comes later.
"""
from repro_torch.core.capture import trace_step
from repro_torch.core.events import CollectiveEvent, Trace
from repro_torch.core.roofline import RooflineReport, roofline
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import H100, Hardware, MeshSpec

__all__ = [
    "CollectiveEvent", "Trace", "TraceStore",
    "Hardware", "MeshSpec", "H100",
    "trace_step",
    "RooflineReport", "roofline",
]
