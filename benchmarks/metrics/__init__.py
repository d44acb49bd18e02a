"""The per-metric readers (one file each, loaded by its metric's name) and
the arithmetic several of them share. A reader's `read(record)` returns the
metric's value, or None where the run gave it nothing to read."""


def per_image(record, phase: str):
    """Seconds of the program's PHASES `phase` in the window per image
    registered in it."""
    n = record["registered"]
    total = record["phases"]["totals"].get(phase)
    return total / n if n and total is not None else None


def idle_pct(record):
    """Percent of the traced window in which no operation ran on the card."""
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def kernel_s(record, names) -> float:
    """Device seconds of the traced kernels whose names contain one of `names`."""
    return sum(s for k, s in record["trace"]["kernel_s"].items() if any(n in k for n in names))
