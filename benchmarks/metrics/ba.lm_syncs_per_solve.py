"""ba.lm_syncs_per_solve: the counters `ba_lm_syncs` over `ba_solves` of the
window (host synchronizations of the LM loop per BA solve)."""


def read(record):
    counts = record["phases"]["counts"]
    solves = counts.get("ba_solves", 0)
    return counts.get("ba_lm_syncs", 0) / solves if solves else None
