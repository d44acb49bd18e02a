"""sift.ms_per_image: the program's span `extract.device` (a batch's
upload, SIFT and fetch, on the extractor's caller thread) over the images
extracted in the window, in ms."""


def read(record):
    total = record["phases"]["totals"].get("extract.device")
    n = sum(j["views"] for j in record["jobs"])
    return 1e3 * total / n if n and total is not None else None
