"""timing_ms.capture: mean host ms of ``pipeline.offline.estimate_timing``
(stage 1) a capture, in a span that waits for the card before it closes."""


def read(run):
    calls = run.spans.get("timing", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
