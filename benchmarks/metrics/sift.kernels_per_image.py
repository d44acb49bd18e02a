"""sift.kernels_per_image: the device kernels (copies and sets aside) that
start inside the program's `extract.device` spans (benchmarks/spans.py's
span table of a traced run) over the images extracted in the window."""


def read(record):
    row = (record.get("span_table") or {}).get("extract.device")
    n = sum(j["views"] for j in record["jobs"])
    return row["kernels"] / n if row and row["kernels"] and n else None
