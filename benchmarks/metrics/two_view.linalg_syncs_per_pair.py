"""two_view.linalg_syncs_per_pair: the counter `linalg_syncs` (host
synchronizations of the two-view banks' solvers) over the pairs matched."""


def read(record):
    n = sum(j.get("pairs_matched", 0) for j in record["jobs"])
    syncs = record["phases"]["counts"].get("linalg_syncs")
    return syncs / n if n and syncs is not None else None
