"""ate_mm: the reference's RMS camera-centre error of the window's first job
(the anchor capture) against the generator's truth, in the map frame with
no alignment."""


def read(record):
    value = record["check"]["first_job"].get("ate_mm")
    return value if value is not None and value != float("inf") else None
