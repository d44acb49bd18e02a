"""match.host_ms_per_pair: the matcher's host stages, the program's spans
`match.prep` (SQLite reads), `match.assemble`, `two_view.classify` and
`match.write` (SQLite), summed over threads, over the pairs matched, in
ms."""

SPANS = ("match.prep", "match.assemble", "two_view.classify", "match.write")


def read(record):
    totals = record["phases"]["totals"]
    n = sum(j.get("pairs_matched", 0) for j in record["jobs"])
    if not n or not any(s in totals for s in SPANS):
        return None
    return 1e3 * sum(totals.get(s, 0.0) for s in SPANS) / n
