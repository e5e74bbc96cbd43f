from cst_captioning_tpu_torch.serving.engine import (
    CaptionResult,
    CaptionService,
    ClipRequest,
    ServeReport,
    SloMonitor,
    load_snapshot,
    request_drain,
    static_batch_serve,
)
from cst_captioning_tpu_torch.serving.pages import (
    OutOfPages,
    PageBank,
    gather_bank,
)
from cst_captioning_tpu_torch.serving.traffic import (
    Trace,
    TraceItem,
    TrafficSpec,
    make_trace,
    synth_request_features,
)

__all__ = [
    "CaptionResult",
    "CaptionService",
    "ClipRequest",
    "OutOfPages",
    "PageBank",
    "ServeReport",
    "SloMonitor",
    "Trace",
    "TraceItem",
    "TrafficSpec",
    "gather_bank",
    "load_snapshot",
    "make_trace",
    "request_drain",
    "static_batch_serve",
    "synth_request_features",
]
