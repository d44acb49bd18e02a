"""two_view.verify_ms_per_pair: the program's span `two_view.verify` (a
chunk's E/F/H and pose banks with their fetch, on the matcher's pool
threads, summed over threads) over the pairs matched, in ms."""


def read(record):
    total = record["phases"]["totals"].get("two_view.verify")
    n = sum(j.get("pairs_matched", 0) for j in record["jobs"])
    return 1e3 * total / n if n and total is not None else None
