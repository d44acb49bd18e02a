"""extract.ms_per_image: the harness's `extract` spans in the window (around
run_feature_extractor) over the images extracted, in ms."""


def read(record):
    jobs = [j for j in record["jobs"] if "extract_s" in j]
    n = sum(j["views"] for j in jobs)
    return 1e3 * sum(j["extract_s"] for j in jobs) / n if n else None
