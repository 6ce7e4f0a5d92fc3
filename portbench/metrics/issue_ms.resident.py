"""issue_ms.resident: mean host ms of the unfenced step call (the harness's
timer around it), over the traced window."""


def read(run):
    calls = run.spans.get("issue", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
