"""two_view.idle_ms_per_pair: the device-idle seconds inside the union of
the program's `two_view.verify` spans over the matcher's threads
(benchmarks/spans.py's span table of a traced run) over the pairs matched,
in ms."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0:  # no device time: nothing idles
        return None
    row = (record.get("span_table") or {}).get("two_view.verify")
    n = sum(j.get("pairs_matched", 0) for j in record["jobs"])
    return 1e3 * row["idle_s"] / n if row and n else None
