"""guided.ms_per_pair: the program's span `match.guided` (a chunk's guided
re-match with its fetch, on the matcher's pool threads, summed over
threads) over the pairs matched, in ms."""


def read(record):
    total = record["phases"]["totals"].get("match.guided")
    n = sum(j.get("pairs_matched", 0) for j in record["jobs"])
    return 1e3 * total / n if n and total is not None else None
