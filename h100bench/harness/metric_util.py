"""Arithmetic shared by the metric readers."""


def roofline(run, kernel: str):
    """Sum of least times over sum of device times of ``kernel``'s calls in
    the traced window, %; None where it made no call or no kernel time."""
    if run.trace is None:
        return None
    calls = run.trace.calls.get(kernel) or []
    bound = sum(b for b, _ in calls)
    spent = sum(t for _, t in calls)
    if not calls or spent <= 0:
        return None
    return 100.0 * bound / spent
