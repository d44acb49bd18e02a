"""match.ms_per_pair: the harness's `match` spans in the window (around
run_sequential_matcher) over the pairs matched, in ms."""


def read(record):
    jobs = [j for j in record["jobs"] if "match_s" in j]
    n = sum(j["pairs_matched"] for j in jobs)
    return 1e3 * sum(j["match_s"] for j in jobs) / n if n else None
