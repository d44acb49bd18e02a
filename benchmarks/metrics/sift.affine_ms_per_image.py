"""sift.affine_ms_per_image: the program's span `sift.affine` (a batch's
affine shape adaptation, inside `extract.device` on the extractor's caller
thread) over the images extracted in the window, in ms."""


def read(record):
    total = record["phases"]["totals"].get("sift.affine")
    n = sum(j["views"] for j in record["jobs"])
    return 1e3 * total / n if n and total is not None else None
