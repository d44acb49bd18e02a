"""lidar.proj_idle_s_per_image: the device-idle seconds inside the
program's `lidar_assoc_proj` spans (benchmarks/spans.py's span table of a
traced run) over the images registered in the window."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0:  # no device time: nothing idles
        return None
    row = (record.get("span_table") or {}).get("lidar_assoc_proj")
    n = record["registered"]
    return row["idle_s"] / n if row and n else None
